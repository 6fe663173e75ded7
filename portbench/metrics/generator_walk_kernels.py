"""generator_walk_kernels: kernels, copies and memsets per call launched
inside the cloud generator's level walk (solvers/cloud_generator.py
_level_walk: the cloud-top trigger, the Markov walk and the
inhomogeneity draws, loops over the levels)."""
SPANS = {"generator_walk": [
    "ecrad_tpu_torch.solvers.cloud_generator:_level_walk"]}


def read(t):
    if not t.has("generator_walk") or not t.device_ops:
        return None
    return t.launches("generator_walk") / t.calls
