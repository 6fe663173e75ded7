"""PyTorch port: McICA's cloud generator kernel (csrc/mcica_generator.cu)
against its plain version, solvers/cloud_generator.cloud_generator_plain,
on the CPU.

The kernel's device code (csrc/mcica_generator.cuh) is plain C++ apart
from CUDA's qualifiers. Here g++ builds it with those defined away and
with -ffp-contract=off, as nvcc builds it with -fmad=false, and runs it
a block at a time: one thread a block, or four OS threads with a barrier
for __syncthreads, so that every strided loop and barrier of the block
runs concurrently (the card's blocks have 32-256 threads; four keep the
test fast on a loaded host). On the same
uniforms it must give the plain path's cloudy masks, od_scaling within
1e-5 relative in float32 (the JAX test's bound, tests/
test_torch_cloud_generator.py) and 1e-12 in float64, and the total cover
within 2e-6 and 1e-13, under the three overlap schemes and beta overlap,
both PDF sample forms, ng of 1, 112 and 140, 24 and 137 levels, and
columns made to reach the cover's edges (clear, overcast, many objects
tied at zero overlap, fractions at the Exp-Exp threshold, zero overlap).

The wrapper (ops/mcica_generator.py) refuses CPU tensors, other dtypes
and strided operands; cloud_generator on CPU tensors takes the plain
stages. tests/test_torch_kernels_gpu.py holds the kernel to the plain
path on the card.
"""
import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.config import Overlap
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.ops import _cuda, mcica_generator
from ecrad_tpu_torch.ops import random_fields as fields
from ecrad_tpu_torch.solvers import cloud_generator as gen
from ecrad_tpu_torch.solvers import pdf_sampler as ppdf
from ecrad_tpu_torch.types import Cloud, Thermodynamics
from ecrad_tpu_torch.utils import hooks

# per dtype: od_scaling relative, total cover absolute
BOUNDS = {torch.float32: (1e-5, 2e-6), torch.float64: (1e-12, 1e-13)}

# CUDA's qualifiers and built-ins for a host build of the device code:
# blocks run one after another, a block's threads as OS threads
SHIM = r"""
#pragma once
#include <math.h>
#include <pthread.h>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)
struct EmuDim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local EmuDim3 threadIdx;
inline EmuDim3 blockIdx, blockDim;
inline pthread_barrier_t emu_barrier;
inline void __syncthreads() { pthread_barrier_wait(&emu_barrier); }
template <typename T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
using std::max;
using std::min;
"""

DRIVER = r"""
#include <thread>
#include <vector>
#include "mcica_generator.cuh"
namespace ecrad { namespace gen { alignas(16) unsigned char smem[1 << 22]; } }

template <typename T>
static int run(int threads, const void* frac, const void* overlap,
               const void* fsd, const void* rand_top, const void* rand_cloud,
               const void* u1, const void* u2, const void* cheb,
               const void* val, int ncol, int nlev, int ng, int scheme,
               int beta, int nfsd, int ncdf, double frac_threshold,
               double inv_decorr, double fsd1, double inv_fsd_interval,
               double zsum, double zdiff, void* od_scaling,
               void* total_cover) {
  const ecrad::gen::Args<T> a = {
      (const T*)frac, (const T*)overlap, (const T*)fsd, (const T*)rand_top,
      (const T*)rand_cloud, (const T*)u1, (const T*)u2, (const float*)cheb,
      (const T*)val, ncol, nlev, ng, scheme, beta, nfsd, ncdf,
      frac_threshold, inv_decorr, fsd1, inv_fsd_interval, zsum, zdiff,
      (T*)od_scaling, (T*)total_cover};
  if (ecrad::gen::Layout(nlev).bytes<T>() > sizeof(ecrad::gen::smem))
    return 1;
  blockDim.x = threads;
  pthread_barrier_init(&emu_barrier, nullptr, threads);
  for (int c = 0; c < ncol; ++c) {
    blockIdx.x = c;
    std::vector<std::thread> block;
    for (int t = 0; t < threads; ++t)
      block.emplace_back([t, &a] {
        threadIdx.x = t;
        ecrad::gen::mcica_generator_kernel<T>(a);
      });
    for (auto& t : block) t.join();
  }
  pthread_barrier_destroy(&emu_barrier);
  return 0;
}

extern "C" int emulate(int f64, int threads, const void* frac,
                       const void* overlap, const void* fsd,
                       const void* rand_top, const void* rand_cloud,
                       const void* u1, const void* u2, const void* cheb,
                       const void* val, int ncol, int nlev, int ng,
                       int scheme, int beta, int nfsd, int ncdf,
                       double frac_threshold, double inv_decorr, double fsd1,
                       double inv_fsd_interval, double zsum, double zdiff,
                       void* od_scaling, void* total_cover) {
  return (f64 ? run<double> : run<float>)(
      threads, frac, overlap, fsd, rand_top, rand_cloud, u1, u2, cheb, val,
      ncol, nlev, ng, scheme, beta, nfsd, ncdf, frac_threshold, inv_decorr,
      fsd1, inv_fsd_interval, zsum, zdiff, od_scaling, total_cover);
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    """The device code built for the host; skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "driver.cc").write_text(DRIVER)
    lib = d / "libemu.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fPIC", "-shared", "-pthread", f"-I{d}",
                    f"-I{_cuda.CSRC}", "-o", str(lib), str(d / "driver.cc")],
                   check=True, capture_output=True, text=True)
    emu = ctypes.CDLL(str(lib))
    emu.emulate.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                            + [ctypes.c_int] * 7 + [ctypes.c_double] * 6
                            + [ctypes.c_void_p] * 2)
    emu.emulate.restype = ctypes.c_int
    return emu


def run_emulated(emu, threads, overlap_scheme, frac_threshold, frac,
                 overlap_param, decorrelation_scaling, fractional_std,
                 pdf_sampler, is_beta_overlap, table, rand_top, rand_cloud,
                 u1, u2):
    """The kernel's arguments as generator_kernel passes them, on CPU
    tensors."""
    ncol, nlev = frac.shape
    ng = rand_top.shape[-1]
    dtype = frac.dtype
    table, val = ((table, None) if pdf_sampler.cheb is not None
                  else (None, table))
    od = torch.empty((ncol, nlev, ng), dtype=dtype)
    tcc = torch.empty((ncol,), dtype=dtype)
    ptr = lambda t: None if t is None else t.data_ptr()
    ops = [t.contiguous() for t in (frac, overlap_param, fractional_std,
                                    rand_top, rand_cloud, u1, u2)]
    err = emu.emulate(
        int(dtype == torch.float64), threads, *map(ptr, ops), ptr(table),
        ptr(val), ncol, nlev, ng, int(overlap_scheme), int(is_beta_overlap),
        pdf_sampler.nfsd, pdf_sampler.ncdf, frac_threshold,
        1.0 / decorrelation_scaling, pdf_sampler.fsd1,
        pdf_sampler.inv_fsd_interval, pdf_sampler.z0 + pdf_sampler.z1,
        pdf_sampler.z1 - pdf_sampler.z0, od.data_ptr(), tcc.data_ptr())
    assert err == 0
    return od, tcc


def edge_columns(nlev, dtype):
    """Columns at the cover's edges: clear; overcast; a zigzag of many
    objects with zero overlap between them (every candidate of every
    merge pass ties at 0: the first is taken); fractions at the Exp-Exp
    object threshold (1e-6) and just above; a cloud with zero overlap
    inside it. The other overlaps are drawn apart, as real ones are: with
    one overlap at every level, the candidates' products would differ in
    their last bits only, and the merge order, and so the cover, would
    follow the last bit of each program's log (the plain path on the CPU
    and on the card and the kernel gave three covers of such a column,
    0.909, 0.935 and 0.936). Returns frac, overlap_param, fractional_std."""
    lev = np.arange(nlev)
    frac = np.zeros((5, nlev))
    frac[1] = 1.0
    frac[2] = np.where(lev % 2 == 0, 0.5, 0.3)
    frac[3] = np.where(lev % 3 == 0, 1e-6, np.where(lev % 3 == 1, 2e-6, 0))
    frac[4, nlev // 4: 3 * nlev // 4] = 0.4
    overlap = np.random.RandomState(7).uniform(0.3, 0.95, (5, nlev - 1))
    overlap[2, 1::2] = 0.0
    overlap[4, nlev // 2 - 1: nlev // 2 + 1] = 0.0
    fsd = np.linspace(0.0, 4.5, 5 * nlev).reshape(5, nlev)
    return tuple(torch.tensor(x, dtype=dtype) for x in (frac, overlap, fsd))


def cloud_case(ncol, nlev, seed, dtype):
    """make_clouds' clouds as the McICA path hands them to the generator
    (overlap parameter from a 2 km decorrelation length, cropped), then
    the edge columns; frac, overlap_param, fractional_std."""
    cols = make_clouds(make_columns(ncol, nlev, seed), seed)
    t = lambda k: torch.as_tensor(cols[k])
    c = Cloud(**{k: t(k) for k in ("q_liq", "q_ice", "re_liq", "re_ice",
                                   "fraction", "fractional_std")})
    c = c.set_overlap_param(Thermodynamics(t("pressure_hl"),
                                           t("temperature_hl")), 2000.0)
    c = c.crop_cloud_fraction()
    made = [getattr(c, k).to(dtype) for k in ("fraction", "overlap_param",
                                              "fractional_std")]
    return tuple(torch.cat([m, e]) for m, e in
                 zip(made, edge_columns(nlev, dtype)))


def sampler(lut_dir, shape, table):
    path = os.path.join(lut_dir, f"synthetic_mcica_{shape}.nc")
    s = ppdf.setup_pdf_sampler(type("C", (), {"cloud_pdf_file": path}))
    if table:
        s.cheb = None
    return s


def assert_generator_close(got, want, dtype):
    """The kernel's contract against the plain path: identical cloudy
    masks, od_scaling relative and total cover absolute bounds."""
    (od, tcc), (od_ref, tcc_ref) = got, want
    rel, tcc_abs = BOUNDS[dtype]
    assert od.dtype == tcc.dtype == dtype
    assert od.shape == od_ref.shape and tcc.shape == tcc_ref.shape
    assert torch.equal(od > 0, od_ref > 0)
    assert bool((od - od_ref).abs().le(rel * od_ref.abs()).all()), \
        float(((od - od_ref).abs() / od_ref.abs().clamp(min=1e-30)).max())
    assert float((tcc - tcc_ref).abs().max()) <= tcc_abs


@pytest.fixture(scope="module")
def lut_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("luts"))
    write_synthetic_luts(d, 0)
    return d


# overlap, beta overlap, PDF shape, bilinear table (else Chebyshev), ng,
# seed offset, levels
CASES = {
    "exp_exp_fast_sw": (Overlap.EXPONENTIAL_EXPONENTIAL, False, "gamma",
                        False, 112, 0, 24),
    "exp_exp_fast_lw_137": (Overlap.EXPONENTIAL_EXPONENTIAL, False, "gamma",
                            False, 140, 997, 137),
    "exp_exp_beta_table_sw": (Overlap.EXPONENTIAL_EXPONENTIAL, True,
                              "gamma", True, 112, 0, 24),
    "exp_ran_fast_lw": (Overlap.EXPONENTIAL_RANDOM, False, "gamma", False,
                        140, 997, 24),
    "exp_ran_beta_fast_sw_137": (Overlap.EXPONENTIAL_RANDOM, True,
                                 "lognormal", False, 112, 0, 137),
    "exp_ran_table_lw": (Overlap.EXPONENTIAL_RANDOM, False, "lognormal",
                         True, 140, 997, 24),
    "max_ran_fast_sw": (Overlap.MAXIMUM_RANDOM, False, "lognormal", False,
                        112, 0, 24),
    "max_ran_table_mono": (Overlap.MAXIMUM_RANDOM, False, "gamma", True, 1,
                           0, 137),
    "exp_exp_fast_mono": (Overlap.EXPONENTIAL_EXPONENTIAL, False, "gamma",
                          False, 1, 997, 24),
}


@functools.lru_cache(maxsize=None)
def case_args(lut_dir, case, dtype, ncol=7, seed=3):
    """cloud_generator_plain's arguments for a case, on CPU tensors (one
    tuple a case, shared by the tests that read it; none writes to it)."""
    overlap, beta, shape, table, ng, offset, nlev = CASES[case]
    frac, op, fsd = cloud_case(ncol, nlev, seed, dtype)
    iseed = torch.arange(frac.shape[0], dtype=torch.int32) + offset
    # contiguous, as the card's random-fields kernel gives them
    uniforms = [u.contiguous() for u in
                fields.random_fields_plain(iseed, ng, nlev, dtype)]
    s = sampler(lut_dir, shape, table)
    return (overlap, 1e-6, frac, op, 0.5, fsd, s, beta,
            ppdf.pdf_table(s, dtype, "cpu"), *uniforms)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_code_matches_plain(emulator, lut_dir, case, dtype, threads):
    args = case_args(lut_dir, case, dtype)
    want = gen.cloud_generator_plain(*args)
    got = run_emulated(emulator, threads, *args)
    assert_generator_close(got, want, dtype)
    # the clear column gives zeros, the overcast one a full cover
    ncol = args[2].shape[0]
    assert float(got[1][ncol - 5]) == 0.0
    assert not bool(got[0][ncol - 5].any())
    assert float(got[1][ncol - 4]) == 1.0


def test_kernel_code_with_other_decorrelation_and_threshold(emulator,
                                                            lut_dir):
    """pow's general form (1 / 0.7), the square root (decorrelation
    scaling 2) and a cloud fraction threshold that drops columns."""
    args = list(case_args(lut_dir, "exp_ran_fast_lw", torch.float32))
    for scaling, threshold in ((0.7, 1e-6), (2.0, 0.3)):
        args[1], args[4] = threshold, scaling
        assert_generator_close(run_emulated(emulator, 1, *args),
                               gen.cloud_generator_plain(*args),
                               torch.float32)


def test_cpu_generator_takes_the_plain_stages(lut_dir, monkeypatch):
    """cloud_generator on CPU tensors: the plain stages in their scopes,
    the kernel not launched."""
    overlap, beta, *_ = CASES["exp_exp_fast_sw"]
    args = case_args(lut_dir, "exp_exp_fast_sw", torch.float32)
    frac, op, fsd, s = args[2], args[3], args[5], args[6]
    monkeypatch.setattr(hooks, "LHOOK", True)
    hooks.reset_profile()
    n0 = mcica_generator.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        od, tcc = gen.cloud_generator(112, torch.arange(frac.shape[0]),
                                      overlap, 1e-6, frac, op, 0.5, fsd, s,
                                      is_beta_overlap=beta, table=args[8])
    counts = hooks.counters()
    hooks.reset_profile()
    assert mcica_generator.launches == n0
    names = {e.name for e in prof.events()}
    for stage in ("cover", "random", "walk", "sample"):
        assert f"ecrad.cloud_generator.{stage}" in names, stage
    assert "ecrad.cloud_generator.kernel" not in names
    assert counts["cloud_cover.merge_passes"] > 0
    assert not any(k.startswith("launch.") for k in counts)
    # the same answer as the plain stages on these uniforms
    iseed = torch.arange(frac.shape[0])
    want = gen.cloud_generator_plain(
        *args[:9], *fields.random_fields_plain(iseed, 112, frac.shape[1],
                                               torch.float32))
    assert torch.equal(od, want[0]) and torch.equal(tcc, want[1])


def test_kernel_wrapper_refuses_what_it_does_not_take(lut_dir):
    """CPU tensors, dtypes other than float32 and float64, mixed dtypes,
    strided operands and a wrong shape raise before any launch."""
    args = list(case_args(lut_dir, "exp_exp_fast_sw", torch.float32))
    n0 = mcica_generator.launches
    with pytest.raises(ValueError, match="CUDA"):
        mcica_generator.generator_kernel(*args)
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        half = [a.to(dtype) if isinstance(a, torch.Tensor) else a
                for a in args]
        with pytest.raises(TypeError):
            mcica_generator.generator_kernel(*half)
    mixed = list(args)
    mixed[10] = mixed[10].double()
    with pytest.raises(TypeError, match="rand_cloud"):
        mcica_generator.generator_kernel(*mixed)
    strided = list(args)
    strided[11] = strided[11].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mcica_generator.generator_kernel(*strided)
    short = list(args)
    short[3] = short[3][:, 1:]
    with pytest.raises(ValueError, match="overlap_param"):
        mcica_generator.generator_kernel(*short)
    assert mcica_generator.launches == n0
