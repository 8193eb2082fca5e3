"""Port serving against the JAX package: fp32 greedy tokens, the engine's
step functions (with the VLM's patches and the enc-dec frames), the
serve-workflow twin on the copied LocalRunner, and the serve launcher on the
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.engine import greedy_generate as jgreedy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import engine, workflow  # noqa: E402

torch.set_num_threads(2)

STEPS = 12


@pytest.fixture(scope="module")
def yi_fp32():
    """yi-9b smoke in fp32 compute: JAX params and their converted twin."""
    jcfg = jconfigs.get_smoke("yi-9b").replace(compute_dtype="float32")
    cfg = configs.get_smoke("yi-9b").replace(compute_dtype="float32")
    p_j = jlm.init(jax.random.PRNGKey(0), jcfg)
    p_t = to_torch(jax.tree.map(np.asarray, p_j), device="cpu")
    return jcfg, cfg, p_j, p_t


def test_greedy_tokens_equal_jax(yi_fp32):
    jcfg, cfg, p_j, p_t = yi_fp32
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref = np.asarray(jgreedy(p_j, jcfg, jnp.asarray(prompt), STEPS))
    stats = {}
    out = engine.greedy_generate(p_t, cfg, torch.from_numpy(prompt), STEPS, stats=stats)
    assert out.shape == (2, STEPS)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_greedy_tokens_equal_jax_recurrent(arch):
    """fp32 greedy tokens of the recurrent smoke archs equal the JAX
    engine's (a 20-token prompt: mamba2 pads it to its 16-row chunks)."""
    jcfg = jconfigs.get_smoke(arch).replace(compute_dtype="float32")
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    p_j = jlm.init(jax.random.PRNGKey(1), jcfg)
    p_t = to_torch(jax.tree.map(np.asarray, p_j), device="cpu")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    ref = np.asarray(jgreedy(p_j, jcfg, jnp.asarray(prompt), STEPS))
    out = engine.greedy_generate(p_t, cfg, torch.from_numpy(prompt), STEPS)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_step_functions_compose_to_greedy(yi_fp32):
    _, cfg, _, p_t = yi_fp32
    prompt = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, 10)).astype(np.int64))
    prefill = engine.make_prefill_step(cfg, max_len=10 + 6)
    decode = engine.make_decode_step(cfg)
    cache, logits = prefill(p_t, {"tokens": prompt})
    toks = [logits.argmax(-1)[:, None]]
    for _ in range(5):
        logits, cache = decode(p_t, toks[-1], cache)
        toks.append(logits.argmax(-1)[:, None])
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  engine.greedy_generate(p_t, cfg, prompt, 6).numpy())


def test_serve_workflow_twin_returns_jax_tokens_exactly_once(yi_fp32):
    jcfg, cfg, p_j, p_t = yi_fp32
    out = workflow.run(p_t, cfg, batch=2, prompt_len=16, steps=STEPS, seed=7)
    assert out["completions"] == 1
    assert 1 <= out["decode_calls"] <= 2
    prompt = np.array(workflow.prompt_ids(cfg, 2, 16, 7), np.int32)
    ref = np.asarray(jgreedy(p_j, jcfg, jnp.asarray(prompt), STEPS))
    np.testing.assert_array_equal(np.array(out["ids"]), ref)
    assert out["text"][0].startswith(f"<{ref[0, 0]}>")


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_prefill_step_takes_patches_and_frames_as_jax(arch):
    """``make_prefill_step`` hands the inputs' ``patches`` and ``frames`` to
    prefill, as the reference's engine does: fp32 last logits at 1e-4, the
    cache's pos (patches counted) and its mk/mv (the frames' length); then
    ``make_decode_step`` against the reference's."""
    jcfg = jconfigs.get_smoke(arch).replace(compute_dtype="float32")
    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    p_j = jlm.init(jax.random.PRNGKey(3), jcfg)
    p_t = to_torch(jax.tree.map(np.asarray, p_j), device="cpu")
    rng = np.random.default_rng(3)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    if cfg.n_patches:
        inputs["patches"] = rng.standard_normal((2, cfg.n_patches, 1024)).astype(np.float32)
    if cfg.frame_input:
        inputs["frames"] = rng.standard_normal((2, 5, 1024)).astype(np.float32)
    max_len = 24 + cfg.n_patches
    cache_j, logits_j = jengine.make_prefill_step(jcfg, max_len=max_len)(
        p_j, {k: jnp.asarray(v) for k, v in inputs.items()})
    cache_t, logits_t = engine.make_prefill_step(cfg, max_len=max_len)(
        p_t, {k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    assert cache_t["pos"] == int(cache_j["pos"]) == cfg.n_patches + 16
    if cfg.enc_dec:
        assert cache_t["blocks"]["s0"]["mk"].shape == cache_j["blocks"]["s0"]["mk"].shape
        assert cache_t["blocks"]["s0"]["mk"].shape[-3] == 5
    tok = np.argmax(np.asarray(logits_j), -1)[:, None].astype(np.int32)
    dec_j, _ = jengine.make_decode_step(jcfg)(p_j, jnp.asarray(tok), cache_j)
    dec_t, _ = engine.make_decode_step(cfg)(p_t, torch.from_numpy(tok), cache_t)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), atol=1e-4, rtol=1e-4)
    # greedy_generate takes the same stubs: its first two tokens are these
    out = engine.greedy_generate(p_t, cfg, torch.from_numpy(inputs["tokens"]), 2,
                                 **{k: torch.from_numpy(v) for k, v in inputs.items()
                                    if k != "tokens"})
    np.testing.assert_array_equal(out[:, 0].numpy(), tok[:, 0])
    np.testing.assert_array_equal(out[:, 1].numpy(), np.argmax(np.asarray(dec_j), -1))


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])
def test_launch_serve_on_cpu(capsys, arch):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16", "--gen", "4"]) == 0
    text = capsys.readouterr().out
    assert "ms/token" in text and "tok/s" in text and "on cpu" in text
    # CPU tensors take the plain versions: no kernel launches are counted
    r = launch_serve.run(arch, smoke=True, batch=2, prompt_len=8, gen=2, device="cpu")
    assert r["launches"] == {"flash_attention": 0, "ssd_scan": 0, "rglru_scan": 0,
                             "ssd_scan_bwd": 0, "rglru_scan_bwd": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("name", [
    "void ssd_sm90::ssd_chunk_state_kernel<64>(__nv_bfloat16 const*, float const*)",
    "ssd_sm90::ssd_state_pass_kernel(float*, float const*, float*, int, int, int, int)",
    "void ssd_sm90::ssd_chunk_scan_kernel<128>(__nv_bfloat16 const*, float const*)"])
def test_profile_classes_the_mma_ssd_kernels_as_ssd_scan(name):
    """The mma variant's three device kernels count as ``ssd_scan`` time."""
    assert profile_serve.kernel_class(name) == "ssd_scan"


@pytest.mark.parametrize("vec", [4, 1])
def test_profile_classes_both_rglru_instantiations_as_rglru_scan(vec):
    """The vec4 and scalar instantiations count as ``rglru_scan`` time."""
    name = (f"void (anonymous namespace)::rglru_scan_kernel<{vec}>(float const*, "
            "float const*, float*, int, int)")
    assert profile_serve.kernel_class(name) == "rglru_scan"


def test_profile_serve_on_cpu_reports_host_ops_only():
    r = profile_serve.run("yi-9b", smoke=True, batch=2, prompt_len=16, decode_steps=2,
                          device="cpu")
    for phase in ("prefill", "decode"):
        assert r[phase]["wall_ms"] > 0 and r[phase]["kernel_launches"] == 0
        assert "device_busy_ms" not in r[phase] and r[phase]["top_host_ops_ms"]
    assert profile_serve.kernel_class("void flash_fwd_kernel<float, 64>") == "flash_attention"
    assert profile_serve.kernel_class(
        "void (anonymous namespace)::ssd_scan_kernel<__nv_bfloat16, 64>") == "ssd_scan"
    assert profile_serve.kernel_class(
        "(anonymous namespace)::rglru_scan_kernel(float const*)") == "rglru_scan"
    assert profile_serve._union_us([(0, 4), (2, 6), (8, 9)]) == 7


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_profile_serve_on_cpu_runs_the_modal_archs(arch):
    """The enc-dec config's encoder gets frames; the VLM serves text only."""
    r = profile_serve.run(arch, smoke=True, batch=2, prompt_len=16, decode_steps=2,
                          device="cpu")
    assert r["arch"] == arch and r["prefill"]["wall_ms"] > 0 and r["decode"]["wall_ms"] > 0
