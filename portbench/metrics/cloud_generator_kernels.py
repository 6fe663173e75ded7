"""cloud_generator_kernels: kernels, copies and memsets per call launched
inside McICA's cloud generator."""
from portbench.spans import pick

SPANS = pick("cloud_generator")


def read(t):
    if not t.has("cloud_generator") or not t.device_ops:
        return None
    return t.launches("cloud_generator") / t.calls
