"""GLL-collocated stiffness on a box of axis-aligned cells.

On such a cell the stiffness is a sum over the axes of the 1D stiffness
D^T W D / h along one axis times the GLL weights of the other two, which
are diagonal. So an axis costs one precomputed 1D product (2 m^4) and the
other two axes' weights as one scaling (m^3); then the sum over the axes
(2 m^3) and the assembly add (m^3): 6 m^4 + 6 m^3 a cell, m = p + 1
nodes a direction, a multiply-add counted as two operations. A general
hex, with its three derivatives and their transposes applied apart, costs
about twice that: another operator.
"""


def cell_flops(degree: int, config: dict) -> int:
    m = degree + 1
    return 6 * m ** 4 + 6 * m ** 3
