"""host_syncs_per_call: the statements of a call that block the host on
the card (a device value read on the host, a copy from pageable host
memory, an index sized by device data), per call. The port runs each
through ecrad_tpu_torch.utils.hooks.sync; the benchmark's span around
that function counts them. A capture of the call in a CUDA graph needs
none."""
from portbench.program import span_count

SPANS = {"sync": ["ecrad_tpu_torch.utils.hooks:sync"]}


def read(t):
    return span_count(t, "sync") / t.calls if t.device_ops else None
