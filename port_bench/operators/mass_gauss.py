"""Consistent mass with Gauss quadrature, sum-factorised.

A cell: interpolation to the Gauss points, x then y then z (2 q m^3,
2 q^2 m^2, 2 q^3 m), the quadrature weight (q^3), the transposed
interpolation (the same three) and the assembly add (m^3):
4 (q m^3 + q^2 m^2 + q^3 m) + q^3 + m^3, m = p + 1 nodes and q =
``config["gauss_points"]`` points a direction, a multiply-add counted as
two operations.
"""


def cell_flops(degree: int, config: dict) -> int:
    m, q = degree + 1, config["gauss_points"]
    return 4 * (q * m ** 3 + q ** 2 * m ** 2 + q ** 3 * m) + q ** 3 + m ** 3
