"""solver_other_ms: device ms per call launched inside the solvers but
outside the cloud generator, regions, layer optics, sweeps and LW
derivatives: the solvers' own passes (McICA's blends, the Tripleclouds
LW region properties)."""
from portbench.spans import ENTRY, SOLVER, per_call_ms

SPANS = {"solvers": ENTRY["solvers"], **SOLVER}


def read(t):
    if not t.has("solvers"):
        return None
    inner = sum(t.device_s(k) for k in SOLVER)
    return per_call_ms(t.device_s("solvers") - inner, t)
