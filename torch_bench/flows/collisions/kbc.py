"""The program's entropic KBC collision (lettuce's ``KBCCollision``, D2Q9
and D3Q27) at the flow's relaxation time. It takes no parameters."""


def program(lt, flow, params):
    return lt.KBCCollision(tau=flow.units.relaxation_parameter_lu)
