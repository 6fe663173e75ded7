"""PyTorch port: the plain version of kernel B10 (`eval_sections`, the
weighted table-row interpolation of the per-band taumol path) against
the JAX package's reference, `ecrad_tpu.ops.gather_interp.eval_sections(
..., use_pallas=False)`.

Cases: plain, eta and mixed section lists like tests/test_gather_interp.py
and tools/check_kernel_equivalence.py, and rows past both ends of their
table (the reference clips every row, for an EtaSection the flattened
row, and never zeroes a term). Both sides get the same numpy inputs.
Bounds: 1e-6 (float32) and 1e-12 (float64) of the output's largest
value; both sides sum the same terms in the same order, so in practice
they agree to rounding. The float64 reference runs under
`jax.enable_x64`. The kernel itself runs only on a GPU
(tests/test_torch_kernels_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.ops import gather_interp as jgi
from ecrad_tpu_torch.ops import gather_interp as pgi

N = 301
BOUNDS = {"float32": 1e-6, "float64": 1e-12}


def _rand_case(name, seed, dtype):
    """numpy description of a section list: ("plain", table, rows,
    weights) or ("eta", table, grids, grid_terms, etas, eta_terms)."""
    rng = np.random.RandomState(seed)
    dt = np.dtype(dtype)

    def plain(r, k, g, lo=0, hi=None):
        hi = r if hi is None else hi
        return ("plain", rng.rand(r, g).astype(dt),
                [rng.randint(lo, hi, N).astype(np.int32) for _ in range(k)],
                [rng.rand(N).astype(dt) for _ in range(k)])

    def eta(r1, r2, g, gos, eos, grid=(0, None), eta_rows=(1, None)):
        g_lo, g_hi = grid[0], r1 - 1 if grid[1] is None else grid[1]
        e_lo, e_hi = eta_rows[0], r2 - 2 if eta_rows[1] is None \
            else eta_rows[1]
        return ("eta", rng.rand(r1, r2, g).astype(dt),
                [rng.randint(g_lo, g_hi, N).astype(np.int32)
                 for _ in range(2)],
                [[(o, rng.rand(N).astype(dt)) for o in gos]
                 for _ in range(2)],
                [rng.randint(e_lo, e_hi, N).astype(np.int32)
                 for _ in range(2)],
                [[(o, rng.rand(N).astype(dt)) for o in eos]
                 for _ in range(2)])

    return {
        "plain": lambda: [plain(65, 4, 12)],
        "eta_lw_absa": lambda: [eta(65, 9, 12, (0, 1), (-1, 0, 1, 2))],
        "eta_lw_absb": lambda: [eta(235, 5, 12, (0, 1), (0, 1))],
        "mixed": lambda: [plain(10, 2, 12), eta(19, 9, 12, (0, 1), (0, 1)),
                          plain(300, 4, 12)],
        # rows from -7 to R + 6: clipped to the first and last row
        "plain_out_of_range": lambda: [plain(20, 3, 8, lo=-7, hi=26)],
        # flattened eta rows below 0 and above R1 * R2 - 1; the eta axis
        # alone also leaves [0, R2) without the flat row leaving the table
        "eta_out_of_range": lambda: [eta(13, 9, 8, (-1, 0, 1),
                                         (-3, 0, 1, 4), grid=(-2, 15),
                                         eta_rows=(-4, 12))],
    }[name]()


def _jax_sections(case):
    out = []
    for s in case:
        if s[0] == "plain":
            out.append(jgi.Section(s[1], [jnp.asarray(r) for r in s[2]],
                                   [jnp.asarray(w) for w in s[3]]))
        else:
            out.append(jgi.EtaSection(
                s[1], [jnp.asarray(x) for x in s[2]],
                [[(o, jnp.asarray(w)) for o, w in f] for f in s[3]],
                [jnp.asarray(x) for x in s[4]],
                [[(o, jnp.asarray(w)) for o, w in f] for f in s[5]]))
    return out


def _port_sections(case):
    out = []
    for s in case:
        if s[0] == "plain":
            out.append(pgi.Section(s[1], [torch.as_tensor(r) for r in s[2]],
                                   [torch.as_tensor(w) for w in s[3]]))
        else:
            out.append(pgi.EtaSection(
                s[1], [torch.as_tensor(x) for x in s[2]],
                [[(o, torch.as_tensor(w)) for o, w in f] for f in s[3]],
                [torch.as_tensor(x) for x in s[4]],
                [[(o, torch.as_tensor(w)) for o, w in f] for f in s[5]]))
    return out


CASES = ["plain", "eta_lw_absa", "eta_lw_absb", "mixed",
         "plain_out_of_range", "eta_out_of_range"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_reference(name, dtype):
    case = _rand_case(name, CASES.index(name), dtype)
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jgi.eval_sections(_jax_sections(case), N,
                                           use_pallas=False,
                                           dtype=getattr(jnp, dtype)))
    got = pgi.eval_sections(_port_sections(case), N)
    assert got.dtype == getattr(torch, dtype) and ref.dtype == dtype
    assert got.shape == ref.shape == (case[0][1].shape[-1], N)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= BOUNDS[dtype], err


def test_out_of_range_rows_are_clipped_not_zeroed():
    """A row below 0 reads row 0 and one past the end the last row, with
    the full weight (B1's rule, a zero weight, differs: the per-band
    path follows the reference)."""
    tab = np.arange(12, dtype=np.float32).reshape(4, 3)
    rows = torch.tensor([-5, -1, 0, 3, 4, 9], dtype=torch.int32)
    w = torch.full((6,), 2.0)
    out = pgi.eval_sections([pgi.Section(tab, [rows], [w])], 6)
    want = 2.0 * tab[np.clip(rows.numpy(), 0, 3)].T
    np.testing.assert_array_equal(out.numpy(), want)
    # an EtaSection clips the FLAT row: eta -1 at grid 1 reads grid 0's
    # last eta row, not grid 1's first
    etab = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    sec = pgi.EtaSection(etab, [torch.tensor([1], dtype=torch.int32)],
                         [[(0, torch.ones(1))]],
                         [torch.tensor([-1], dtype=torch.int32)],
                         [[(0, torch.ones(1))]])
    np.testing.assert_array_equal(pgi.eval_sections([sec], 1).numpy()[:, 0],
                                  etab.reshape(8, 3)[3])


def test_terms_sum_in_section_then_term_order():
    """The first term, then each later one added: a sum whose float32
    value depends on the order (1e8 + 1 - 1e8)."""
    tab = np.array([[1e8], [1.0], [-1e8]], np.float32)
    rows = [torch.full((1,), i, dtype=torch.int32) for i in range(3)]
    ones = [torch.ones(1) for _ in range(3)]
    out = pgi.eval_sections([pgi.Section(tab, rows[:2], ones[:2]),
                             pgi.Section(tab, rows[2:], ones[2:])], 1)
    assert float(out[0, 0]) == float((np.float32(1e8) + np.float32(1.0))
                                     - np.float32(1e8))


def test_pack_sections_descriptor():
    """The kernel's descriptor, operand table and compacted tables for a
    mixed list: the layout csrc/gather_sections.cu reads (every table of
    this case lives on all 12 columns: 3 groups of 4)."""
    case = _rand_case("mixed", 3, "float32")
    secs = _port_sections(case)
    p = pgi.pack_sections(secs, N, "cpu")
    d = p.desc.tolist()
    # sections, segments, terms, operands; one segment of 3 groups
    assert d[:6] == [3, 1, 2 + 2 * 2 * 2 + 4, 24, 0, 3] and p.g == 12
    # per section: first group, end group, first term, end term
    assert d[6:18] == [0, 3, 0, 2, 0, 3, 2, 10, 0, 3, 10, 14]
    terms = [d[18 + 9 * k:18 + 9 * (k + 1)] for k in range(14)]
    # plain(10 x 12): offset, rows, stride, row, weight operands
    assert terms[:2] == [[0, 10, 12, 0, 1, -1, 0, 0, 0],
                         [0, 10, 12, 2, 3, -1, 0, 0, 0]]
    # eta(19, 9): per family (grid, eta, 2 gw, 2 ew operands), go, eo
    for fam in range(2):
        base = 4 + 6 * fam
        assert terms[2 + 4 * fam:6 + 4 * fam] == [
            [120, 19 * 9, 12, base, base + 2 + go, base + 1, base + 4 + eo,
             9, go * 9 + eo] for go in (0, 1) for eo in (0, 1)]
    assert terms[10:] == [[120 + 19 * 9 * 12, 300, 12, 16 + 2 * k,
                           17 + 2 * k, -1, 0, 0, 0] for k in range(4)]
    assert p.tab.numel() == (10 + 19 * 9 + 300) * 12 and p.nterms == 14
    assert all(o.dtype == (torch.int32 if i in (0, 2, 4, 5, 10, 11)
                           or (i >= 16 and i % 2 == 0) else torch.float32)
               for i, o in enumerate(p.operands))
    np.testing.assert_array_equal(p.operands[5].numpy(), case[1][4][0])
    assert p.ptrs.tolist() == [o.data_ptr() for o in p.operands]


def test_kernel_wrapper_refuses_cpu_tensors():
    case = _port_sections(_rand_case("plain", 0, "float32"))
    before = pgi.launches["gather_sections"]
    with pytest.raises(ValueError, match="CUDA"):
        pgi.eval_sections_kernel(case, N)
    assert pgi.launches["gather_sections"] == before
