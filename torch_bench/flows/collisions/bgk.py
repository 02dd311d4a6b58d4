"""The program's BGK collision at the flow's relaxation time. It takes no
parameters."""


def program(lt, flow, params):
    return lt.BGKCollision(tau=flow.units.relaxation_parameter_lu)
