"""plain_on_card_per_call: the layers of a call that ran their plain
PyTorch version in place of their kernel on the card, per call. The port
reports each through ecrad_tpu_torch.utils.hooks.plain_on_device; the
benchmark's span around that function counts them. On a path whose
kernels all take its dtype it reads 0."""
from portbench.program import span_count

SPANS = {"plain_on_device": ["ecrad_tpu_torch.utils.hooks:plain_on_device"]}


def read(t):
    return span_count(t, "plain_on_device") / t.calls if t.device_ops \
        else None
