"""The vision-language family against the JAX reference package: M-RoPE
(``apply_mrope`` and the attention layer's three position planes), the
vision splice of ``apply_lm``/``lm_loss``/``lm_prefill``, and
``qwen2-vl-72b``'s reduced config end to end.

On ``qwen2-vl-reduced`` from ``lm_state_from_jax`` of the reference's
``init_lm`` (its qkv biases drawn at random, so that they count):
``apply_lm`` with vision embeddings and with (3, B, S) ids of three
distinct planes, the loss and every gradient, ``lm_prefill`` with vision
embeddings and its caches, decode steps after it, a text chunk chain,
one ``build_train_step`` step; ``host_batch`` with ``vision_len``; the
config, its registry entry and the full config's counts on ``meta``.

Tolerances: f32 1e-5 of the largest magnitude (M-RoPE, cache leaves),
logits and gradients 1e-4, a loss 1e-5 relative, 1e-2 relative L2 under
the config's own policy (bf16 products, DESIGN.md §10).  On the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import qwen2_vl_72b as jvl
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen2_vl_72b as tvl
from repro_torch.data import pipeline
from repro_torch.models import attention as attn
from repro_torch.models import layers, lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep

TOL = 1e-5
LOGITS_TOL = 1e-4
BF16_TOL = 1e-2
MAX_LEN = 24
S, SV, B = 16, 6, 2          # tokens, vision positions, batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pair(precision=None):
    cj, ct = jvl.reduced(), tvl.reduced()
    if precision:
        cj = jbase.with_precision(cj, precision)
        ct = tbase.with_precision(ct, precision)
    return cj, ct


def _lm(cj, ct, seed=0):
    params = jlm.init_lm(jax.random.PRNGKey(seed), cj)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if str(path[-1].key) in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _inputs(seed, n=B, s=S, sv=SV, d=64):
    """tokens (n, s), vision embeddings (n, sv, d) and three distinct
    position planes (3, n, s), as Qwen2-VL's patch grid gives them: a
    frame id, a row and a column for the vision positions, then text."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (n, s)).astype(np.int32)
    ve = rng.standard_normal((n, sv, d)).astype(np.float32)
    grid = np.stack([np.zeros(sv), np.arange(sv) // 3, np.arange(sv) % 3])
    text = np.arange(s - sv)[None] + grid.max() + 1
    pos = np.concatenate([grid, np.repeat(text, 3, 0)], 1).astype(np.int32)
    return toks, ve, np.broadcast_to(pos[:, None], (3, n, s)).copy()


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


_apply = jax.jit(jlm.apply_lm, static_argnums=1)
_prefill = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))
_chunk = jax.jit(jlm.lm_prefill_chunk, static_argnums=1)
_decode = jax.jit(jlm.lm_decode_step, static_argnums=1)


# ---------------------------------------------------------------------------
# M-RoPE.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,theta", [((16, 24, 24), 1e6),
                                            ((4, 2, 2), 1e4),
                                            ((1, 2, 5), 1e6)])
def test_apply_mrope_matches_jax(sections, theta):
    """Three distinct planes: f32 within 1e-5 of the largest magnitude,
    bf16 in and out within 1e-2 relative L2; the equal-plane call is
    apply_rope bit for bit."""
    d = 2 * sum(sections)
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 9)).astype(np.int32)
    # Eager, as apply_rope's test: jitted, XLA's f32 angles at positions
    # near 4 000 move the result by ~1e-4 of its largest magnitude.
    ref = jlayers.apply_mrope
    got = layers.apply_mrope(_t(x), _t(pos), sections, theta)
    want = ref(jnp.asarray(x), jnp.asarray(pos), sections, theta)
    assert got.dtype == torch.float32
    _close(got, want, TOL, "f32")
    got = layers.apply_mrope(_t(x).bfloat16(), _t(pos), sections, theta)
    want = ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), sections,
               theta)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, want) <= BF16_TOL
    same = _t(np.broadcast_to(pos[:1], pos.shape).copy())
    assert torch.equal(layers.apply_mrope(_t(x), same, sections, theta),
                       layers.apply_rope(_t(x), same[0], theta))


def test_apply_mrope_reads_each_plane_in_its_sections():
    """Moving one plane moves only its own frequency slots (and their
    rotation partners in the other half); the sections must sum to D/2."""
    x = torch.randn(1, 1, 1, 16, generator=torch.Generator().manual_seed(0))
    base = torch.zeros(3, 1, 1, dtype=torch.int32)
    for plane, (lo, hi) in enumerate(((0, 4), (4, 6), (6, 8))):
        pos = base.clone()
        pos[plane] = 7
        moved = (layers.apply_mrope(x, pos, (4, 2, 2))
                 != layers.apply_mrope(x, base, (4, 2, 2)))[0, 0, 0]
        slots = moved[:8] | moved[8:]
        assert slots.nonzero().flatten().tolist() == list(range(lo, hi))
    with pytest.raises(ValueError, match="sum to head_dim / 2 = 8"):
        layers.apply_mrope(x, base, (4, 2, 1))


def test_attention_layer_with_three_planes_matches_jax():
    """The Attention layer under ``mrope_sections`` at (3, B, S) ids
    against the reference's ``apply_attention``, and at (B, S) ids, which
    both read as three equal planes: bit for bit rope's."""
    cfg = attn.AttentionConfig(dim=32, n_heads=4, n_kv_heads=2,
                               qkv_bias=True, rope_theta=1e6,
                               mrope_sections=(2, 1, 1))
    jcfg = jattn.AttentionConfig(dim=32, n_heads=4, n_kv_heads=2,
                                 qkv_bias=True, rope_theta=1e6,
                                 mrope_sections=(2, 1, 1))
    pol = layers.DTypePolicy(torch.float32, torch.float32)
    jpol = jlayers.DTypePolicy(jnp.float32, jnp.float32)
    params = jattn.init_attention(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    params = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.3, v.dtype)
              if k.startswith("b") else v for k, v in params.items()}
    layer = attn.Attention(cfg, pol, generator=None, device="meta")
    layer.load_state_dict({k: _t(np.asarray(v)) for k, v in params.items()},
                          assign=True)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 10)).astype(np.int32)
    with torch.no_grad():
        got = layer(_t(x), _t(pos))
        want = jax.jit(lambda p, a, i: jattn.apply_attention(
            p, a, jcfg, positions=i, policy=jpol))(
                params, jnp.asarray(x), jnp.asarray(pos))
        _close(got, want, LOGITS_TOL)
        flat = _t(pos[0])
        rope = attn.Attention(dataclasses.replace(cfg, mrope_sections=None),
                              pol, generator=None, device="meta")
        rope.load_state_dict(layer.state_dict(), assign=True)
        assert torch.equal(layer(_t(x), flat), rope(_t(x), flat))


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_runs():
    """The reduced model under f32 on both sides: {what: (port,
    reference)} for apply_lm with vision embeddings and 2-D ids, with
    three distinct planes, lm_prefill with vision embeddings (logits and
    caches), 3 decode steps after it, and a text chunk chain."""
    cj, ct = _pair("f32")
    params, model = _lm(cj, ct)
    toks, ve, pos = _inputs(0)
    jt, jve = jnp.asarray(toks), jnp.asarray(ve)
    t, tve = _t(toks).long(), _t(ve)
    out = {}
    with torch.no_grad():
        out["apply_lm vision"] = (
            lm.apply_lm(model, t, vision_embeds=tve),
            _apply(params, cj, jt, vision_embeds=jve)[0])
        out["apply_lm planes"] = (
            lm.apply_lm(model, t, vision_embeds=tve, positions=_t(pos)),
            _apply(params, cj, jt, vision_embeds=jve,
                   positions=jnp.asarray(pos))[0])
        logits, caches = lm.lm_prefill(model, t, MAX_LEN, vision_embeds=tve)
        jlogits, jcaches, _ = _prefill(params, cj, jt, MAX_LEN,
                                       vision_embeds=jve)
        out["lm_prefill"] = (logits, jlogits)
        out["lm_prefill caches"] = (caches, jcaches)
        tok = np.argmax(np.asarray(jlogits)[:, -1:], -1).astype(np.int32)
        got, want = [], []
        for _ in range(3):
            lg, caches = lm.lm_decode_step(model, _t(tok).long(), caches)
            jlg, jcaches = _decode(params, cj, jnp.asarray(tok), jcaches)
            got.append(lg)
            want.append(jlg)
            tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)
        out["lm_decode_step"] = (torch.cat(got, 1), jnp.concatenate(want, 1))
        out["lm_decode_step caches"] = (caches, jcaches)
        c = lm.init_lm_cache(ct, B, MAX_LEN, device="cpu")
        jc = jlm.init_lm_cache(cj, B, MAX_LEN)
        got, want = [], []
        for lo in range(0, S, 8):
            lg, c = lm.lm_prefill_chunk(model, t[:, lo:lo + 8], c, lo)
            jlg, jc = _chunk(params, cj, jt[:, lo:lo + 8], jc, lo)
            got.append(lg)
            want.append(jlg)
        out["lm_prefill_chunk"] = (torch.cat(got, 1),
                                   jnp.concatenate(want, 1))
        out["lm_prefill_chunk caches"] = (c, jc)
    return out


F32_CASES = ("apply_lm vision", "apply_lm planes", "lm_prefill",
             "lm_prefill caches", "lm_decode_step", "lm_decode_step caches",
             "lm_prefill_chunk", "lm_prefill_chunk caches")


@pytest.mark.parametrize("case", F32_CASES)
def test_lm_paths_match_jax_at_f32(f32_runs, case):
    """Logits within 1e-4 of the largest, every KV cache leaf within 1e-5
    (the reference nests an attn stage's leaves under "attn")."""
    got, want = f32_runs[case]
    if not case.endswith("caches"):
        assert got.shape == (B, got.shape[1], 512)
        _close(got, want, LOGITS_TOL, case)
        return
    assert sorted(got) == sorted(want)
    for key in want:
        for name, w in want[key]["attn"].items():
            _close(got[key][name], w, TOL, f"{case} {key}/{name}")


def test_vision_embeds_replace_the_first_positions():
    """The splice: the first S_vis rows of the embedded input are the
    vision embeddings in the compute dtype, the rest the tokens'; logits
    at every position depend on them (causal attention reads them)."""
    _, ct = _pair()
    model = lm.LM(ct, device="cpu", generator=torch.Generator().manual_seed(1))
    toks, ve, _ = _inputs(1)
    t, tve = _t(toks).long(), _t(ve)
    x = model.embed_tokens(t, tve)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x[:, :SV], tve.bfloat16())
    assert torch.equal(x[:, SV:], model.embed_tokens(t)[:, SV:])
    with torch.no_grad():
        a = lm.apply_lm(model, t, vision_embeds=tve)
        b = lm.apply_lm(model, t, vision_embeds=tve + 1)
    assert (a != b).any(-1).all()


def test_equal_planes_are_the_two_dimensional_call():
    """apply_lm with (3, B, S) ids of three equal planes gives the 2-D
    call's logits bit for bit (M-RoPE reduces to rope exactly)."""
    _, ct = _pair("f32")
    model = lm.LM(ct, device="cpu", generator=torch.Generator().manual_seed(2))
    toks, ve, pos = _inputs(2)
    flat = _t(pos[1])
    with torch.no_grad():
        two = lm.apply_lm(model, _t(toks).long(), vision_embeds=_t(ve),
                          positions=flat)
        three = lm.apply_lm(model, _t(toks).long(), vision_embeds=_t(ve),
                            positions=flat[None].expand(3, -1, -1))
    assert torch.equal(two, three)


def test_lm_matches_jax_under_its_own_policy():
    """f32 parameters, bf16 products: apply_lm with vision embeddings and
    distinct planes, and the prefill, within 1e-2 relative L2."""
    cj, ct = _pair()
    params, model = _lm(cj, ct, seed=3)
    toks, ve, pos = _inputs(3)
    with torch.no_grad():
        got = lm.apply_lm(model, _t(toks).long(), vision_embeds=_t(ve),
                          positions=_t(pos))
        logits, _ = lm.lm_prefill(model, _t(toks).long(), MAX_LEN,
                                  vision_embeds=_t(ve))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, _apply(params, cj, jnp.asarray(toks),
                               vision_embeds=jnp.asarray(ve),
                               positions=jnp.asarray(pos))[0]) <= BF16_TOL
    assert _rel_l2(logits, _prefill(params, cj, jnp.asarray(toks), MAX_LEN,
                                    vision_embeds=jnp.asarray(ve))[0]) \
        <= BF16_TOL


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def _batch(seed, n=B, seq=S, sv=SV):
    """The training batch the launcher draws for a vlm: host_batch with
    vision_len and d_model."""
    return pipeline.host_batch(pipeline.DataConfig(
        vocab=512, seq_len=seq, global_batch=n, seed=seed, vision_len=sv,
        d_model=64), 0)


def _loss_and_grads(model, batch):
    loss, parts = lm.lm_loss(model, {k: _t(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss.detach(), parts, dict(zip(names, grads))


def test_host_batch_draws_the_vision_embeddings_as_the_reference():
    """vision_len and d_model: the tokens, labels and vision embeddings
    bit for bit the reference's, for two steps and two seeds."""
    for seed, step in ((0, 0), (3, 5)):
        kw = dict(vocab=512, seq_len=12, global_batch=3, seed=seed,
                  vision_len=5, d_model=8)
        got = pipeline.host_batch(pipeline.DataConfig(**kw), step)
        want = jpipe.host_batch(jpipe.DataConfig(**kw), step)
        assert sorted(got) == sorted(want) == [
            "labels", "tokens", "vision_embeds"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["vision_embeds"].shape == (3, 5, 8)


@pytest.fixture(scope="module")
def reference_grads():
    """(reference config, port config, parameters, batch, the reference's
    f32 loss and its gradients in the port's names)."""
    cj, ct = _pair("f32")
    params, _ = _lm(cj, ct, seed=4)
    b = _batch(4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, cj, jb), has_aux=True))(params)
    return cj, ct, params, b, float(want), lm_state_from_jax(
        jax.tree.map(np.asarray, want_g))


@pytest.mark.parametrize("remat", ["none", "unit"])
def test_lm_loss_and_gradients_match_jax(reference_grads, remat):
    """f32 with vision embeddings: the loss within 1e-5 relative, each
    gradient within 1e-4 of its leaf's largest (the qkv biases' and the
    embedding's among them), under either remat."""
    cj, ct, _, b, want, want_g = reference_grads
    _, model = _lm(cj, dataclasses.replace(ct, remat=remat), seed=4)
    loss, parts, grads = _loss_and_grads(model, b)
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    assert grads.keys() == want_g.keys()
    for n, w in want_g.items():
        _close(grads[n], w, LOGITS_TOL, n)


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _first_step_direction(g, norm, cfg):
    g = g.astype(np.float64) * min(cfg.grad_clip / float(norm), 1.0)
    return g / (np.abs(g) + cfg.eps)


def test_train_step_matches_jax(reference_grads):
    """One ``build_train_step`` step on a batch with vision embeddings
    against the reference's: loss 1e-5 relative, grad_norm and lr 1e-6,
    each parameter within 1e-5 of its leaf's largest plus twice the step
    noise its two gradients predict (tests/test_torch_lm_attn.py)."""
    cj, ct, params, b, _, gj = reference_grads
    _, model = _lm(cj, ct, seed=4)
    ocfg = AdamWConfig(**OPT)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    gt = _loss_and_grads(model, b)[2]
    jstate = {"params": params,
              "opt": jadamw.adamw_init(jadamw.AdamWConfig(**OPT), params)}
    jstate, want = jax.jit(jstep.build_train_step(
        cj, jadamw.AdamWConfig(**OPT)))(jstate, jb)
    state = tstep.init_train_state(model, ocfg)
    state, got = tstep.build_train_step(model, ocfg)(
        state, {k: _t(v) for k, v in b.items()})
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-6), ("lr", 1e-6)):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol,
                                   err_msg=k)
    lr = float(want["lr"])
    for n, w in lm_state_from_jax(jax.tree.map(
            np.asarray, jstate["params"])).items():
        w = _np(w)
        noise = lr * np.abs(
            _first_step_direction(_np(gt[n]), got["grad_norm"], ocfg)
            - _first_step_direction(_np(gj[n]), want["grad_norm"], ocfg))
        diff = np.abs(_np(state["params"][n]) - w)
        assert (diff <= 1e-5 * np.abs(w).max() + 2 * noise).all(), n


def test_train_launcher_trains_the_vl_model_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --arch qwen2-vl-72b --reduced --device cpu``:
    the batches carry seq // 2 vision positions, the losses are finite."""
    from repro_torch.launch import train as ltrain

    tr = ltrain.main(["--arch", "qwen2-vl-72b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path)])
    assert "qwen2-vl-reduced on cpu" in capsys.readouterr().out
    assert tr.data_cfg.vision_len == 8 and tr.data_cfg.d_model == 64
    assert tr.step == 2 and all(map(np.isfinite, tr.history))


# ---------------------------------------------------------------------------
# Config, registry, counts, serving.
# ---------------------------------------------------------------------------

def test_config_and_entry_match_the_reference():
    for make in ("full", "reduced"):
        mine, theirs = getattr(tvl, make)(), getattr(jvl, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                continue
            want, got = getattr(theirs, f.name), getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
    a, b = tbase.get_arch("qwen2-vl-72b"), jbase.get_arch("qwen2-vl-72b")
    assert (a.name, a.family, a.skip_shapes, a.source) == \
        (b.name, b.family, b.skip_shapes, b.source)


def test_full_config_on_meta_has_the_reference_counts():
    """72 706 203 648 parameters and 72 704 065 536 active (the
    reference's); the 2-layer cut the card runs holds 4 246 794 240."""
    cfg = tvl.full()
    assert lm.count_params(lm.LM(cfg, device="meta")) == 72_706_203_648
    assert lm.count_active_params(cfg) == \
        jlm.count_active_params(jvl.full()) == 72_704_065_536
    cut = dataclasses.replace(cfg, unit=(("attn", 2),), n_layers=2)
    assert lm.count_params(lm.LM(cut, device="meta")) == 4_246_794_240
    assert lm.supports_chunked_prefill(cfg)


def test_engine_serves_text_prompts_through_chunks():
    """qwen2-vl serves text prompts through the chunked engine: greedy
    tokens equal decoding from the one-shot prefill."""
    from repro_torch.serve.engine import Request, ServeEngine

    _, ct = _pair("f32")
    model = lm.LM(ct, device="cpu", generator=torch.Generator().manual_seed(6))
    prompt = np.random.default_rng(6).integers(0, 512, 13)
    eng = ServeEngine(model, batch_size=2, max_len=32, prefill_chunk=4)
    assert eng.prefill_chunk == 4
    h = eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=3))
    eng.run()
    assert h.result().prefill_chunks == 4
    with torch.no_grad():
        logits, c = lm.lm_prefill(model, _t(prompt).long()[None], 32)
        want = [int(logits[0, -1].argmax())]
        for _ in range(2):
            lg, c = lm.lm_decode_step(model, torch.tensor([[want[-1]]]), c)
            want.append(int(lg[0, -1].argmax()))
    assert h.result().tokens == want
