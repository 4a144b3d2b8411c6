"""GLL-collocated stiffness on a general (non-affine) hex cell.

A cell's apply, sum-factorised, with m = p + 1 nodes a direction and a
multiply-add counted as two operations:

- the three reference derivatives of u at the m^3 points, one 1D
  product of m terms along one axis each: 3 x 2 m x m^3 = 6 m^4;
- the symmetric 3 x 3 geometry G = J^-1 J^-T |det J| w applied to the
  gradient at each point, nine multiply-adds: 18 m^3;
- the three transposed derivatives, one 1D product each: 6 m^4;
- their sum (two adds a point) and the assembly add: 3 m^3;

12 m^4 + 21 m^3 a cell: twice the box's 1D products (``stiffness_gll_box``,
whose geometry is diagonal and folded into them) and the full geometry.
"""


def cell_flops(degree: int, config: dict) -> int:
    m = degree + 1
    return 12 * m ** 4 + 21 * m ** 3

