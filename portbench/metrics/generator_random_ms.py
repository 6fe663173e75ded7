"""generator_random_ms: device ms per call of the work launched inside the
cloud generator's random fields (solvers/cloud_generator.py
random_fields: threefry's passes, utils/threefry.py)."""
from portbench.spans import per_call_ms

SPANS = {"generator_random": [
    "ecrad_tpu_torch.solvers.cloud_generator:random_fields"]}


def read(t):
    if not t.has("generator_random"):
        return None
    return per_call_ms(t.device_s("generator_random"), t)
