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
