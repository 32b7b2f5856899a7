"""cg_roofline_bal: cg_roofline's share (the least time of
`schur_cg_solve` over its measured time, A read once per CG iteration at
the camera's width, here BAL's 9) for the cells with BAL's cameras."""

from portbench.metrics.cg_roofline import read  # noqa: F401
