"""The work of a layer is counted at its call boundary: the same for a
kernel's wrapper and its plain version on the same tensors."""
import torch

from portbench import roofline
from ecrad_tpu_torch.solvers import adding, tripleclouds
from ecrad_tpu_torch.ops import mcica_optics

P = "ecrad_tpu_torch.solvers."


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(*shape, generator=g)


def test_adding_wrapper_and_plain_count_alike():
    nlev, ng, ncol = 5, 3, 4
    args = (*(_rand(nlev, ng, ncol, seed=i) * 0.3 for i in range(5)),
            _rand(ng, ncol, seed=6), _rand(ng, ncol, seed=7),
            _rand(ng, ncol, seed=8), _rand(ncol, seed=9) + 0.1)
    plain = adding.adding_sw_plain(*args)
    wrapped = adding.adding_sw(*args)
    target = P + "mcica:adding_sw"
    assert (roofline.call_work(target, args, {}, plain)
            == roofline.call_work(target, args, {}, wrapped))
    nbytes, ops = roofline.call_work(target, args, {}, plain)
    assert nbytes == 4 * (5 * nlev * ng * ncol + 3 * ng * ncol + ncol
                          + 3 * (nlev + 1) * ng * ncol)
    assert ops == 40 * nlev * ng * ncol


def test_a_kernel_returning_views_of_one_buffer_counts_as_plain():
    """Kernel B4 returns ten views of one buffer; its plain version ten
    tensors: the same bytes."""
    ncol, nlev, ng, nb = 3, 4, 5, 2
    args = (_rand(ncol, nlev, ng), _rand(ncol, nlev, ng), _rand(ncol, nlev, ng),
            _rand(ncol, nlev, nb), _rand(ncol, nlev, nb), _rand(ncol, nlev, nb),
            [0, 0, 1, 1, 1], _rand(ncol, nlev, ng),
            _rand(ncol, nlev) > 0.5, _rand(ncol) + 0.1, False)
    plain = mcica_optics.sw_clear_total_reftrans_plain(*args)
    buffer = torch.stack(plain)
    views = tuple(buffer)
    target = P + "mcica:sw_clear_total_reftrans"
    assert (roofline.call_work(target, args, {}, plain)
            == roofline.call_work(target, args, {}, views))


def test_region_sweeps_count_per_region_cell():
    nlev, nreg, ng, ncol = 4, 3, 2, 5
    ref = _rand(nlev, nreg, ng, ncol)
    target = P + "tripleclouds:tc_sw_sweeps"
    _, ops = roofline.call_work(target, (ref,), {}, ())
    assert ops == 60 * nlev * nreg * ng * ncol
    assert tripleclouds.tc_sw_sweeps  # the attribute the span wraps


def test_least_time():
    assert roofline.least_time_s(3.35e12, 0) == 1.0
    assert roofline.least_time_s(0, 67e12) == 1.0
    assert roofline.call_work("no.such:thing", (), {}, ())[1] is None


def test_spartacus_work_is_counted_after_the_window():
    """B6's operations come from its 3D mask, B8's from its column rows,
    as functions that Spans.settle calls once the window has closed; two
    regions have no count."""
    from portbench import harness
    from ecrad_tpu_torch.ops import spartacus_adding as sa

    nlev, ng, ncol = 3, 2, 4
    use3d = _rand(nlev, ng, ncol) > 0.5
    od = _rand(nlev, 3, ng, ncol)
    args = (8.0, od, od, od, None, None, None, use3d, None)
    target = P + "spartacus_sw:sw_reftrans_levels"
    nbytes, count = roofline.call_work(target, args, {}, od)
    n3 = int(use3d.sum())
    assert count() == (use3d.numel() - n3) * 180 + n3 * 3900
    two = (8.0, od[:, :2], od[:, :2], od[:, :2], None, None, None, use3d,
           None)
    assert roofline.call_work(target, two, {}, od)[1] is None

    cols = torch.zeros(nlev, sa.NCOLROWS, ncol)
    cols[:, sa._CLEAR] = cols[:, sa._CLEARP] = 1.0
    cols[1, sa._CLEAR, 0] = 0.0          # one mixed interface
    hist = torch.zeros(nlev, 45, ng, ncol)
    _, count = roofline.call_work(P + "spartacus_sw:sw_adding_sweeps",
                                  (None, hist, cols), {}, ())
    assert count() == ng * (nlev * ncol * 600 + 1 * 1200)

    spans = harness.Spans({})
    spans.work["x"] = {"least_s": 0.0, "ops": 0.0, "unknown": False,
                       "later": [(nbytes, lambda: 67e12)]}
    spans.settle()
    assert spans.work["x"]["ops"] == 67e12
    assert spans.work["x"]["least_s"] == 1.0 and not spans.work["x"]["later"]
