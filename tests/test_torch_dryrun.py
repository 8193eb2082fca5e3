"""The port's dry run against the JAX package's, on fake tensors.

``configs.input_specs`` and ``hlo_analysis.model_flops`` against the
reference's for every (arch × shape) cell; the roofline and wire models at
the H100's constants; each kernel operator's fake implementation and FLOP
formula against the plain version; the op walker's byte accounting; every
smoke arch's train, prefill and decode steps traced (nothing launched); and
the rule table's per-device argument bytes against the reference's
compiled ``memory_analysis`` on a reduced mesh; a 16x16 cell traced on one
rank (more in ``test_torch_dryrun_mesh.py``).

A torch built without CUDA has no CUDA device guard, so autograd on a fake
CUDA tensor cannot run here: the fake tensors live on ``meta``
(``dryrun.fake_device()``), which the kernel wrappers take as the card's.
"""

import gc
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import library, ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch.mesh import make_ctx  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.parallel.sharding import (cache_shardings, input_shardings,  # noqa: E402
                                           param_shardings)
from repro_torch.train.step import train_state_shapes  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CELLS = [(a, s) for a in configs.ARCHS for s in SHAPES]
DEV = dryrun.fake_device()


def _tdtype(d) -> torch.dtype:
    return getattr(torch, np.dtype(d).name)


# ==========================================================================
# input_specs and model_flops, every cell
# ==========================================================================


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    """Same keys, shapes and dtypes as ``repro.configs.input_specs``; a
    decode cache leaf by leaf against ``jax.eval_shape(lm.init_cache)``, its
    ``pos`` a Python int here where the reference's is an int32 scalar."""
    spec = SHAPES[shape]
    want = jconfigs.input_specs(jconfigs.get(arch), spec)
    got = configs.input_specs(configs.get(arch), spec, device="meta")
    assert set(got) == set(want)
    if spec.kind == "decode":
        b, l = spec.global_batch, spec.seq_len
        jcache = jax.eval_shape(lambda: jlm.init_cache(jconfigs.get(arch), b, l))
        want = {"token": want["token"], **{("cache",) + p: v for p, v in _leaves(jcache)}}
        got = {"token": got["token"], **{("cache",) + p: v for p, v in _leaves(got["cache"])}}
        assert set(got) == set(want)
        assert got[("cache", "pos")] == l - 1 and want[("cache", "pos")].dtype == jnp.int32
        del got[("cache", "pos")], want[("cache", "pos")]
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _tdtype(w.dtype), k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_the_reference(arch, shape):
    spec = SHAPES[shape]
    args = (spec.kind, spec.seq_len, spec.global_batch)
    assert ha.model_flops(configs.get(arch), *args) == jha.model_flops(jconfigs.get(arch), *args)


# ==========================================================================
# roofline and wire models at the H100's constants
# ==========================================================================


def test_roofline_terms_and_dominance():
    """The reference test's case at the H100 SXM5's peaks."""
    rl = ha.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12 * 2},
                           wire_bytes=0.0, model_flops_per_device=989e12 / 2)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.dominant == "memory"
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    assert rl.roofline_fraction == pytest.approx(0.25)
    rl = ha.roofline_terms({"flops": 0.0}, wire_bytes=450e9 * 3)
    assert rl.collective_s == pytest.approx(3.0) and rl.dominant == "collective"
    assert (ha.PEAK_FLOPS, ha.PEAK_FLOPS_FP32, ha.HBM_BW, ha.NVLINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


def test_collective_wire_model():
    """The reference test's ring factors: groups of 4 of 8 devices."""
    b = 1024 * 4
    assert ha.wire_bytes("all-reduce", b, 4) == pytest.approx(2 * b * 3 / 4)
    assert ha.wire_bytes("all-gather", b, 4) == pytest.approx(3 * b)
    assert ha.wire_bytes("reduce-scatter", 4 * b, 4) == pytest.approx(3 * b)
    assert ha.wire_bytes("all-to-all", b, 4) == pytest.approx(b * 3 / 4)
    assert ha.wire_bytes("collective-permute", b, 4) == b
    with pytest.raises(ValueError):
        ha.wire_bytes("broadcast", b, 4)


# ==========================================================================
# the kernel operators: fake implementations and FLOP formulas
# ==========================================================================


def _fake_call(fn, *real):
    """``fn`` on fake copies of ``real`` (CPU tensors) on the fake device:
    its outputs' (shape, dtype), the bytes it reported allocating and the
    launches it counted."""
    ops.reset_launches()
    seen = []
    library.allocation_hooks.append(lambda ts: seen.extend(ts))
    try:
        with FakeTensorMode():
            args = [torch.empty(t.shape, dtype=t.dtype, device=DEV)
                    if isinstance(t, torch.Tensor) else t for t in real]
            out = fn(*args)
            shapes = [None if t is None else (tuple(t.shape), t.dtype)
                      for t in (out if isinstance(out, tuple) else (out,))]
            allocated = sum(t.untyped_storage().nbytes() for t in seen)
    finally:
        library.allocation_hooks.pop()
    return shapes, allocated, dict(ops.launches)


def _meta(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


def _flash_cases():
    out = [(b, l, h, hkv, hd, True, w, c, dt)
           for (b, l, h, hkv, hd, w, c, dt, _) in
           ref.FLASH_CASES + ref.FLASH_HD256_CASES + ref.FLASH_HD96_CASES]
    out += [(b, l, h, hkv, hd, causal, w, c, "bfloat16")
            for (b, l, h, hkv, hd, causal, w, c) in ref.FLASH_WGMMA_CASES]
    out += [(b, l, h, hkv, hd, False, w, 0.0, dt)
            for (b, l, h, hkv, hd, w, dt, _) in ref.FLASH_WINDOW_CASES]
    return out


@pytest.mark.parametrize("case", _flash_cases(), ids=str)
def test_flash_fake_matches_plain(case):
    b, l, h, hkv, hd, causal, window, cap, dt = case
    dtype = getattr(torch, dt)
    q = torch.zeros((b, l, h, hd), dtype=dtype)
    kv = torch.zeros((b, l, hkv, hd), dtype=dtype)
    out, lse = ref.flash_attention_plain_lse(q, kv, kv, causal=causal, window=window,
                                             softcap=cap)
    shapes, allocated, launches = _fake_call(
        lambda q, k, v: fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                               softcap=cap, return_lse=True), q, kv, kv)
    assert shapes == _meta([out, lse])
    assert allocated == out.numel() * out.element_size() + lse.numel() * 4
    assert not any(launches.values())
    shapes, _, _ = _fake_call(lambda q, k, v: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                                     window=window), q, kv, kv)
    assert shapes == _meta([out])


@pytest.mark.parametrize("case", _flash_cases(), ids=str)
def test_flash_bwd_fake_matches_plain(case):
    """The backward operator's fake implementation: the plain backward's
    shapes and dtypes, and what the launch allocates, dq, dk, dv, the fp32
    delta [B,H,L] and the mma dk/dv sweep's fp32 partial sums where it
    splits the heads; nothing counted."""
    b, l, h, hkv, hd, causal, window, cap, dt = case
    dtype = getattr(torch, dt)
    q = torch.zeros((b, l, h, hd), dtype=dtype)
    kv = torch.zeros((b, l, hkv, hd), dtype=dtype)
    out, lse = ref.flash_attention_plain_lse(q, kv, kv, causal=causal, window=window,
                                             softcap=cap)
    grads = ops.flash_attention_bwd(q, kv, kv, out, lse, q, causal=causal, window=window,
                                    softcap=cap, block_q=l, block_k=l)
    shapes, allocated, launches = _fake_call(
        lambda q, k, v, o, s, d: fa.flash_attention_bwd(q, k, v, o, s, d, causal=causal,
                                                        window=window, softcap=cap),
        q, kv, kv, out, lse, q)
    assert shapes == _meta(grads)
    splits = fa.bwd_kv_splits(b, l, h, hkv, hd, fa.bwd_variant(hd, dtype))
    part = 2 * splits * kv.numel() * 4 if splits > 1 else 0
    assert allocated == sum(g.numel() * g.element_size() for g in grads) + b * h * l * 4 + part
    assert not any(launches.values())


def _ssd_cases():
    return ([(bt, l, h, p, n, min(chunk, l), dt) for (bt, l, h, p, n, chunk, dt, _) in
             ref.SSD_CASES]
            + [(bt, l, h, p, n, chunk, "bfloat16") for (bt, l, h, p, n, chunk) in
               ref.SSD_MMA_CASES])


@pytest.mark.parametrize("case", _ssd_cases(), ids=str)
def test_ssd_fake_matches_plain(case):
    """Forward with the final state and backward: the plain version's
    shapes and dtypes; the forward reports its outputs and, on the mma
    variant, the three scratch buffers the launch allocates."""
    bt, l, h, p, n, q, dt = case
    dtype = getattr(torch, dt)
    x = torch.zeros((bt, l, h, p), dtype=dtype)
    dtt, a = torch.full((bt, l, h), 0.1), -torch.ones(h)
    bm = torch.zeros((bt, l, n), dtype=dtype)
    y, h_last = ref.ssd_chunked(x, dtt, a, bm, bm, q)
    shapes, allocated, launches = _fake_call(
        lambda *t: ssd.ssd_scan_fwd(*t, q, return_state=True), x, dtt, a, bm, bm)
    assert shapes == _meta([y.to(dtype), h_last])
    nc = l // q
    scratch = (bt * nc * h * (p * n * 6 + q * 4) if ssd.variant(p, n, q, dtype) == "mma"
               else 0)
    assert allocated == x.numel() * x.element_size() + h_last.numel() * 4 + scratch
    assert not any(launches.values())
    grads = ref.ssd_scan_bwd_plain(x.float(), dtt, a, bm.float(), bm.float(), q, x.float())
    shapes, allocated, launches = _fake_call(
        lambda *t: ssd.ssd_scan_bwd(*t[:5], q, t[5], None), x, dtt, a, bm, bm, x)
    assert shapes == [(tuple(g.shape), t.dtype) for g, t in zip(grads, (x, dtt, a, bm, bm))]
    assert allocated > sum(t.numel() * t.element_size() for t in (x, dtt, a, bm, bm))
    assert not any(launches.values())


@pytest.mark.parametrize("case", ref.RGLRU_CASES + ref.RGLRU_EDGE_CASES, ids=str)
def test_rglru_fake_matches_plain(case):
    bt, l, w = case[:3]
    la, b = torch.full((bt, l, w), -0.5), torch.ones((bt, l, w))
    h = ref.rglru_scan_ref(la, b)
    shapes, allocated, launches = _fake_call(rg.rglru_scan_fwd, la, b)
    assert shapes == _meta([h]) and allocated == h.numel() * 4
    shapes, allocated, launches = _fake_call(rg.rglru_scan_bwd, la, h, h)
    assert shapes == _meta(ref.rglru_scan_bwd_plain(la, b, h)) and allocated == 2 * h.numel() * 4
    assert not any(launches.values())


#: (operator call on fake tensors, its FLOPs as the kernel table's bounds
#: count them: PERF.md §6 rounds them to 8.61, 68.7, 171.9, 3.29 and 26.0 GFLOP,
#: 25 and 84 MFLOP)
_BF16, _F32 = torch.bfloat16, torch.float32
FLOP_CASES = {
    "flash yi-9b serving [4,512,32,128]": (
        lambda e: fa.flash_attention_fwd(e((4, 512, 32, 128), _BF16), e((4, 512, 4, 128), _BF16),
                                         e((4, 512, 4, 128), _BF16)), 8_606_711_808),
    "flash yi-9b training [2,2048,32,128] with lse": (
        lambda e: fa.flash_attention_fwd(e((2, 2048, 32, 128), _BF16),
                                         e((2, 2048, 4, 128), _BF16),
                                         e((2, 2048, 4, 128), _BF16), return_lse=True),
        68_753_031_168),
    "flash_attention_bwd yi-9b training [2,2048,32,128]": (
        lambda e: fa.flash_attention_bwd(*(e(s, _BF16) for s in (
            (2, 2048, 32, 128), (2, 2048, 4, 128), (2, 2048, 4, 128), (2, 2048, 32, 128))),
            e((2, 32, 2048), _F32), e((2, 2048, 32, 128), _BF16)), 171_882_577_920),
    "ssd_scan mamba2-370m [4,512,32,64]": (
        lambda e: ssd.ssd_scan_fwd(e((4, 512, 32, 64), _BF16), e((4, 512, 32), _F32),
                                   e((32,), _F32), e((4, 512, 128), _BF16),
                                   e((4, 512, 128), _BF16), 256, return_state=True),
        3_292_790_784),
    "ssd_scan_bwd mamba2-370m training [2,2048,32,64]": (
        lambda e: ssd.ssd_scan_bwd(e((2, 2048, 32, 64), _BF16), e((2, 2048, 32), _F32),
                                   e((32,), _F32), e((2, 2048, 128), _BF16),
                                   e((2, 2048, 128), _BF16), 256, e((2, 2048, 32, 64), _BF16)),
        25_954_877_440),
    "rglru_scan recurrentgemma-9b [4,512,4096]": (
        lambda e: rg.rglru_scan_fwd(e((4, 512, 4096), _F32), e((4, 512, 4096), _F32)),
        25_165_824),
    "rglru_scan_bwd recurrentgemma-9b training [1,4096,4096]": (
        lambda e: rg.rglru_scan_bwd(*(e((1, 4096, 4096), _F32) for _ in range(3))),
        83_886_080),
}


@pytest.mark.parametrize("name", list(FLOP_CASES))
def test_flop_formula_counts_the_kernel_table(name):
    call, want = FLOP_CASES[name]
    with FakeTensorMode():
        with FlopCounterMode(display=False) as counter:
            call(lambda s, d: torch.empty(s, dtype=d, device=DEV))
    assert counter.get_total_flops() == want
    assert len(counter.get_flop_counts()["Global"]) == 1


def test_flash_pairs_count_the_mask():
    """The pairs formula against the plain masks, causal and not, with and
    without a window."""
    for l, s, causal, window in ((64, 64, True, 0), (100, 100, True, 17), (64, 64, False, 9),
                                 (32, 48, False, 0), (40, 40, True, 64)):
        if causal:
            m = attention.make_causal_mask(l, s, window=window)
        elif window:
            m = attention.make_window_mask(l, s, window=window)
        else:
            m = torch.ones((l, s), dtype=torch.bool)
        assert fa.pairs(l, s, causal=causal, window=window) == int(m.sum())


def test_flash_bwd_flops_count_the_visible_pairs():
    """The backward's five products, 2·hd each per pair its mask keeps and
    head: 2.5 times the forward's two, on the same masks as the forward's
    pairs."""
    for l, s, causal, window in ((64, 64, True, 0), (100, 100, True, 17), (64, 64, False, 9),
                                 (32, 48, False, 0), (40, 40, True, 64)):
        if causal:
            m = attention.make_causal_mask(l, s, window=window)
        elif window:
            m = attention.make_window_mask(l, s, window=window)
        else:
            m = torch.ones((l, s), dtype=torch.bool)
        got = fa.bwd_flops(2, l, s, 4, 16, causal=causal, window=window)
        assert got == 10 * 2 * 4 * 16 * int(m.sum())
        assert 2 * got == 5 * fa.flops(2, l, s, 4, 16, causal=causal, window=window)


# ==========================================================================
# the walker
# ==========================================================================


def test_walker_counts_allocations_and_frees_exactly():
    """A hand-built sequence: 1000 B (one 1024-byte block), 4096 B, a view
    (free), an in-place op (no new storage), a free, 600 B; live bytes and
    the peak follow the caching allocator's 512-byte rounding."""
    with FakeTensorMode():
        arg = torch.empty(10, device=DEV)
        with op_cost.OpCounter(op_cost.storages(arg)) as c:
            a = torch.empty(250, device=DEV)                 # 1000 B → 1024
            assert (c.live, c.peak) == (1024, 1024)
            b = torch.zeros(1024, device=DEV)               # 4096 B
            v = b.view(32, 32)
            b.add_(1.0)
            arg.mul_(2.0)
            assert (c.live, c.peak) == (1024 + 4096, 1024 + 4096)
            del a
            gc.collect()
            assert c.live == 4096
            d = torch.ones(150, device=DEV)                  # 600 B → 1024
            assert (c.live, c.peak) == (4096 + 1024, 5120)
            del b
            assert c.live == 4096 + 1024                     # the view keeps b's storage
            del v, d
            gc.collect()
            assert (c.live, c.peak) == (0, 5120)
    assert c.ops == 4                                         # zeros, add_, mul_, ones
    assert c.bytes_written == 4096 * 2 + 40 + 600
    assert c.bytes_read == 4096 + 40


def test_dense_prefill_flops_are_the_analytic_count():
    """yi-9b smoke, L a multiple of the flash block: 2 · the matmul weights
    · tokens over the layers, the head on the last position, and the flash
    formula per layer."""
    cfg = configs.get_smoke("yi-9b")
    b, l = 2, 128
    rec = dryrun.run_cell(cfg, ShapeSpec("t", l, b, "prefill"), verbose=False)
    d, hd = cfg.d_model, cfg.hd
    layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
             + 3 * d * cfg.d_ff)
    want = (2 * layer * b * l * cfg.n_layers + 2 * d * cfg.padded_vocab * b
            + cfg.n_layers * fa.flops(b, l, l, cfg.n_heads, hd))
    assert rec["cost"]["flops"] == want
    assert rec["kernels"]["repro_torch.flash_attention_fwd"]["calls"] == cfg.n_layers


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_smoke_arch_dry_runs(arch, kind):
    """Each step traces on fake tensors, launches and counts nothing, holds
    at least its arguments at its peak, and calls each kernel operator as
    often as the card launches it."""
    cfg = configs.get_smoke(arch)
    ops.reset_launches()
    rec = dryrun.run_cell(cfg, ShapeSpec("smoke", 64, 2, kind), verbose=False)
    assert not any(ops.launches.values())
    m = rec["memory"]
    assert rec["ok"] and m["peak_bytes"] >= m["argument_bytes"] > 0
    assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] \
        - m["alias_bytes"] + m["workspace_bytes"]
    assert m["workspace_bytes"] == (2 if kind == "train" else 1) * ha.CUBLAS_WORKSPACE_BYTES
    assert rec["cost"]["flops"] > 0 and rec["ops"] > 0 and rec["fits"]
    kinds = [cfg.pattern_of(i) for i in range(cfg.n_layers)]
    per = {"repro_torch.flash_attention_fwd": sum(k in ("attn", "local") for k in kinds),
           "repro_torch.ssd_scan_fwd": kinds.count("ssm"),
           "repro_torch.rglru_scan_fwd": kinds.count("rglru")}
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    if kind == "prefill":
        assert calls == {k: n for k, n in per.items() if n}
    elif kind == "decode":
        assert calls == {}
        assert m["alias_bytes"] > 0                          # the cache, updated in place
    else:         # remat "dots" runs a full group's forwards twice, a remainder layer's once
        grouped = lm.groups_of(cfg)[0] * len(cfg.layer_pattern)
        again = [cfg.pattern_of(i) for i in range(grouped)]
        twice = {"repro_torch.flash_attention_fwd": sum(k in ("attn", "local") for k in again),
                 "repro_torch.ssd_scan_fwd": again.count("ssm"),
                 "repro_torch.rglru_scan_fwd": again.count("rglru")}
        want = {k: n + twice[k] for k, n in per.items() if n}
        for fwd, bwd in (("ssd_scan_fwd", "ssd_scan_bwd"), ("rglru_scan_fwd", "rglru_scan_bwd"),
                         ("flash_attention_fwd", "flash_attention_bwd")):
            if per[f"repro_torch.{fwd}"]:
                want[f"repro_torch.{bwd}"] = per[f"repro_torch.{fwd}"]
        assert calls == want


def test_full_config_cell_traces_in_little_memory():
    """yi-9b prefill_32k at full width, in a fresh process: the trace holds
    no data, so the process's max RSS rises by less than 1 GB."""
    code = textwrap.dedent("""
        import resource, torch
        torch.set_num_threads(1)
        from repro_torch.launch import dryrun
        r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        rec = dryrun.run_cell("yi-9b", "prefill_32k", verbose=False)
        rise = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - r0
        print("RISE_KB", rise, rec["ok"], rec["memory"]["peak_bytes"], rec["fits"])
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=SRC), timeout=600)
    assert "RISE_KB" in r.stdout, r.stderr[-3000:]
    _, rise_kb, ok, peak, fits = r.stdout.split()[-5:]
    assert ok == "True" and int(rise_kb) < 1 << 20
    assert int(peak) > ha.HBM_BYTES and fits == "False"     # 32 × 32k tokens do not fit


def test_reduced_mesh_argument_bytes_match_the_reference():
    """At mesh (2,2,2), gemma2-27b smoke, the cells of
    tests/test_sharding_mesh.py::test_reduced_dryrun_all_kinds: the rule
    table's per-device argument bytes against the reference's compiled
    ``memory_analysis().argument_size_in_bytes`` (8 host devices, in a
    subprocess).  The one difference is named: a decode cache's ``pos`` is
    an int32 scalar there (4 bytes on every device) and a Python int here."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import jax, jax.numpy as jnp
        from repro import configs
        from repro.models import lm
        from repro.launch.mesh import make_mesh
        from repro.parallel.mesh_ctx import MeshCtx, mesh_context
        from repro.parallel.sharding import cache_shardings, input_shardings, param_shardings
        from repro.serve.engine import make_decode_step, make_prefill_step
        from repro.train.step import make_train_step, train_state_shapes
        cfg = configs.get_smoke("gemma2-27b")
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        ctx = MeshCtx(mesh, batch_axes=("pod", "data"), fsdp_axes=("data",))
        B, L = 8, 32
        with mesh_context(ctx):
            state = train_state_shapes(cfg)
            st_sh = param_shardings(state, ctx)
            batch = {"tokens": jax.ShapeDtypeStruct((B, L), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((B, L), jnp.int32),
                     "mask": jax.ShapeDtypeStruct((B, L), jnp.float32)}
            c1 = jax.jit(make_train_step(cfg), in_shardings=(st_sh, input_shardings(ctx, batch)),
                         out_shardings=(st_sh, None), donate_argnums=0
                         ).lower(state, batch).compile()
            params = lm.init_shapes(cfg)
            p_sh = param_shardings(params, ctx)
            fn = make_prefill_step(cfg, max_len=L)
            inputs = {"tokens": jax.ShapeDtypeStruct((B, L), jnp.int32)}
            cache_sds, _ = jax.eval_shape(fn, params, inputs)
            c_sh = cache_shardings(cache_sds, ctx)
            c2 = jax.jit(fn, in_shardings=(p_sh, input_shardings(ctx, inputs)),
                         out_shardings=(c_sh, None)).lower(params, inputs).compile()
            tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
            c3 = jax.jit(make_decode_step(cfg),
                         in_shardings=(p_sh, input_shardings(ctx, tok), c_sh),
                         out_shardings=(None, c_sh), donate_argnums=2
                         ).lower(params, tok, cache_sds).compile()
        print("ARG_BYTES", *(c.memory_analysis().argument_size_in_bytes for c in (c1, c2, c3)))
    """)], capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=SRC, XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert "ARG_BYTES" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    want = dict(zip(("train", "prefill", "decode"), map(int, r.stdout.split()[-3:])))

    cfg = configs.get_smoke("gemma2-27b")
    sizes = dryrun.mesh_sizes("2x2x2")
    ctx = make_ctx(sizes)
    b, l = 8, 32

    def on_device(tree, specs):
        return dryrun.local_bytes(tree, specs, sizes)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    state = train_state_shapes(cfg)
    batch = {"tokens": empty((b, l), torch.int32), "labels": empty((b, l), torch.int32),
             "mask": empty((b, l), torch.float32)}
    params = lm.init_shapes(cfg)
    inputs = {"tokens": empty((b, l), torch.int32)}
    cache = lm.init_cache(cfg, b, l, device="meta")
    tok = empty((b, 1), torch.int32)
    got = {"train": on_device(state, param_shardings(state, ctx))
           + on_device(batch, input_shardings(ctx, batch)),
           "prefill": on_device(params, param_shardings(params, ctx))
           + on_device(inputs, input_shardings(ctx, inputs)),
           "decode": on_device(params, param_shardings(params, ctx))
           + on_device(tok, input_shardings(ctx, tok))
           + on_device(cache, cache_shardings(cache, ctx))}
    named = {"train": 0, "prefill": 0, "decode": 4}      # the reference's int32 pos
    assert {k: got[k] + named[k] for k in got} == want


def test_mesh_cell_is_traced():
    """A 16x16 cell traces one rank on fake blocks: 256 devices, its share
    of model_flops, the rule table's argument bytes, collectives and the
    collective roofline term; no process group is left behind."""
    rec = dryrun.run_cell("yi-9b", "decode_32k", mesh="16x16",
                          overrides={"shard_kv_seq": True}, verbose=False)
    assert rec["ok"] and rec["devices"] == 256 and not torch.distributed.is_initialized()
    cfg = configs.get("yi-9b")
    assert rec["model_flops_per_device"] == ha.model_flops(cfg, "decode", 32768, 128) / 256
    sizes = dryrun.mesh_sizes("16x16")
    ctx = make_ctx(sizes, shard_kv_seq=True)
    params = dryrun.serve_dtype(lm.init_shapes(cfg))
    inputs = configs.input_specs(cfg, SHAPES["decode_32k"], device="meta")
    cache = dryrun.serve_dtype(inputs["cache"])
    assert rec["memory"]["argument_bytes"] == (
        dryrun.local_bytes(params, param_shardings(params, ctx), sizes)
        + dryrun.local_bytes(inputs["token"], input_shardings(ctx, inputs["token"]), sizes)
        + dryrun.local_bytes(cache, cache_shardings(cache, ctx), sizes))
    rl = rec["roofline"]
    assert rl["wire_bytes"] > 0 and rl["collective_s"] > 0 and rec["fits"]
    skipped = dryrun.run_cell("yi-9b", "long_500k")
    assert skipped["skip"] == configs.skip_reason("yi-9b", "long_500k")


@pytest.mark.parametrize("knob,value", [("remat", "full"), ("gather_dtype", "bfloat16"),
                                        ("microbatches", 2)])
def test_every_variant_knob_changes_the_trace(knob, value):
    """Each variant the CLI takes reaches the traced training step: its
    record differs from the baseline's in ops or bytes, so no knob is a
    silent no-op; a knob the port has nothing for is not a flag."""
    cfg = configs.get_smoke("yi-9b")
    assert getattr(cfg, knob, None) != value
    spec = ShapeSpec("smoke", 64, 2, "train")
    base = dryrun.run_cell(cfg, spec, verbose=False)
    var = dryrun.run_cell(cfg, spec, overrides={knob: value}, verbose=False)
    assert var["variant"] == f"{knob}={value}" and base["variant"] == "baseline"
    assert (var["ops"], var["cost"]["bytes_accessed"]) != (base["ops"],
                                                          base["cost"]["bytes_accessed"])
    with pytest.raises(SystemExit):
        dryrun._parser().parse_args(["--arch", "yi-9b", "--shape", "train_4k", "--no-scan"])
