"""cover_merge_passes: passes of the Exp-Exp cloud cover's ordered merge
loop per call, over the generator's calls (solvers/cloud_cover.py). The
loop asks the host before each pass and once after the last whether a
column still holds two objects (`_more_to_merge`, a sync), so the passes
are those checks less one per cover computed."""
from portbench.program import span_count

P = "ecrad_tpu_torch.solvers."
SPANS = {"cover_merge": [P + "cloud_cover:_more_to_merge"],
         "cover_exp_exp": [P + "cloud_generator:cum_cloud_cover_exp_exp"]}


def read(t):
    if not t.device_ops:
        return None
    checks, covers = span_count(t, "cover_merge"), span_count(t,
                                                              "cover_exp_exp")
    return (checks - covers) / t.calls if covers else None
