"""cloud_generator_ms: host wall ms per call of McICA's cloud generator
(solvers/mcica.py _generate: cloud cover, the generator, the PDF
sampler, threefry), in the calls made just before the profiler starts,
without it. The generator waits on the card inside its level loops, so
its wall is what the call waits for; under the profiler each of its
launches would cost more."""
from portbench.spans import pick

SPANS = pick("cloud_generator")


def read(t):
    s = t.host_span_s("cloud_generator")
    return None if s is None else s * 1e3
