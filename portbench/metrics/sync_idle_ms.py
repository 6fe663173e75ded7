"""sync_idle_ms: device idle ms per call in the gaps that begin while the
host is blocked in one of the port's syncs (ecrad_tpu_torch.utils.hooks
.sync): the card drains its queue, then waits for the host to launch
again."""
from portbench.program import idle_in_s
from portbench.spans import per_call_ms

SPANS = {"sync": ["ecrad_tpu_torch.utils.hooks:sync"]}


def read(t):
    return per_call_ms(idle_in_s(t, "sync"), t)
