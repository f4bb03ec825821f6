"""Sequence parallelism of the scan (``repro_torch.parallel.gspn_sp``)
against the reference ``repro.parallel.gspn_sp`` on the CPU.

In process: the block operators (``block_transfer_operator``,
``block_boundary_states``, ``propagate_boundary``, ``_apply_transfer``)
against the reference's at 1e-5, the strategy rule, and the single-device
path at K = 1 on a one-rank gloo group.

Spawned: the same numpy inputs (seed 0) go through the reference on a K-
device mesh of forced host devices (``run_sub``) and through the port in K
gloo ranks (``tests/test_torch_sp_worker.py``, one process a rank, as
``torchrun`` starts them) at K = 2 and K = 4, and the port on a 2 x 2
``("data", "seq")`` mesh.  The cases are the reference's own
(``tests/test_gspn_sp.py``): all four directions at H = 21, W = 12 with
compact taps, gradients at the grid's edges for heights K does not
divide, each strategy and exchange mode, the bf16 wire, the collectives
and the ``sp_*`` counters, and the layer wiring through the reference's
parameters.  Tolerances: 1e-5 of the largest magnitude in f32, 1e-2
under the bf16 wire (DESIGN.md §10).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import gspn as jG
from repro.models.vision import GSPNVisionConfig as JVisionConfig
from repro.models.vision import init_vision
from repro.parallel import gspn_sp as jsp
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_sp_mesh
from repro_torch.models.convert import vision_state_from_jax
from repro_torch.parallel import gspn_sp as sp

WORKER = pathlib.Path(__file__).with_name("test_torch_sp_worker.py")
# The small backbone of the reference's wiring test.
VISION = JVisionConfig(name="t", img_size=16, n_classes=4, dims=(8, 12),
                       depths=(1, 1), proxy_dim=2)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
TOL, TOL_BF16 = 1e-5, 1e-2
FIVE = ("x", "wl", "wc", "wr", "lam")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"max error / largest magnitude {err:.3e} > {tol}"


# ---------------------------------------------------------------------------
# Inputs (numpy, seed 0).
# ---------------------------------------------------------------------------

def _taps(rng, gw, h, w, direction="tb"):
    """Row-stochastic taps from random logits, masked in the scan
    geometry of ``direction`` (the reference's ``normalize_taps``)."""
    logits = rng.standard_normal((gw, h, w, 3)).astype(np.float32)
    horizontal = direction in ("lr", "rl")
    if horizontal:
        logits = logits.swapaxes(-3, -2)
    mask = np.zeros((logits.shape[-2], 3), np.float32)
    mask[0, 0] = mask[-1, 2] = np.finfo(np.float32).min
    z = logits + mask
    z = np.exp(z - z.max(-1, keepdims=True))
    z /= z.sum(-1, keepdims=True)
    taps = [z[..., i] for i in range(3)]
    return [t.swapaxes(-1, -2) if horizontal else t for t in taps]


def _sig(rng, shape):
    return (1 / (1 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)


def _single(rng, gw, cpw, h, w):
    g = gw * cpw
    x = rng.standard_normal((g, h, w)).astype(np.float32)
    wl, wc, wr = _taps(rng, gw, h, w)
    return dict(zip(FIVE, (x, wl, wc, wr, _sig(rng, (g, h, w)))))


def _pair(rng, gw, cpw, h, w):
    g = gw * cpw
    x = rng.standard_normal((g, h, w)).astype(np.float32)
    t0, t1 = _taps(rng, gw, h, w), _taps(rng, gw, h, w)
    taps = [np.stack([a, b]) for a, b in zip(t0, t1)]
    return dict(zip(FIVE, (x, *taps, _sig(rng, (2, g, h, w)))))


def make_inputs() -> dict:
    rng = np.random.default_rng(0)
    d = {}

    def put(prefix, arrays):
        d.update({f"{prefix}/{k}": v for k, v in arrays.items()})

    b, cp, h, w = 2, 3, 21, 12
    taps = [_taps(rng, b, h, w, dr) for dr in jG.DIRECTIONS]
    put("dirs", dict(zip(FIVE, (
        rng.standard_normal((b * cp, h, w)).astype(np.float32),
        *(np.stack([t[i] for t in taps]) for i in range(3)),
        _sig(rng, (4, b * cp, h, w))))))
    for h in (19, 9):
        put(f"edge/{h}", _single(rng, 2, 3, h, 8))
    put("pair/0", _pair(rng, 2, 3, 21, 8))
    put("pair/1", _pair(rng, 4, 1, 24, 8))
    put("modes", _pair(rng, 2, 2, 24, 8))
    put("wire", _single(rng, 2, 3, 24, 8))
    put("hybrid", _single(rng, 4, 2, 21, 16))
    put("layers", {
        "xv": rng.standard_normal((2, 14, 14, 16)).astype(np.float32),
        "xt": rng.standard_normal((2, 100, 16)).astype(np.float32),
        "img": rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
        "labels": np.array([1, 3], np.int64)})
    # Parameters in the reference's trees (shapes from its init, values
    # from numpy), named as the port's modules name them.
    def params(init, *a):
        shapes = jax.eval_shape(lambda key: init(key, *a),
                                jax.random.PRNGKey(0))
        return jax.tree.map(lambda l: (0.3 * rng.standard_normal(
            l.shape)).astype(l.dtype), shapes)
    put("attn", params(jG.init_gspn_attention,
                       jG.GSPNAttentionConfig(dim=16, proxy_dim=2)))
    put("mixer", params(jG.init_gspn_seq_mixer,
                        jG.GSPNSeqConfig(dim=16, proxy_dim=2, row_width=8)))
    vision = params(init_vision, VISION)
    put("vision", {k: v.numpy() for k, v in
                   vision_state_from_jax(vision).items()})
    put("vision_leaf", {str(i): leaf for i, leaf in
                        enumerate(jax.tree.leaves(vision))})
    return d


# ---------------------------------------------------------------------------
# The reference on K forced host devices.
# ---------------------------------------------------------------------------

JAX_BODY = """
    import json, sys
    from repro import obs
    from repro.core import gspn as G
    from repro.kernels.ref import gspn_scan_ref
    from repro.launch.mesh import make_sp_mesh
    from repro.models.vision import (GSPNVisionConfig, apply_vision,
                                     init_vision)
    from repro.models.lm import Ctx
    from repro.parallel.gspn_sp import (collectives_in_jaxpr, gspn_scan_sp,
                                        gspn_scan_sp_pair)

    inp = dict(np.load(IN))
    out = {}
    FIVE = ("x", "wl", "wc", "wr", "lam")
    COUNTERS = ("sp_exchanges_total", "sp_collective_ops_total",
                "sp_boundary_bytes_total", "sp_activation_bytes_total",
                "sp_pair_fused_exchanges_total")

    def args(prefix):
        return tuple(jnp.asarray(inp[f"{prefix}/{n}"]) for n in FIVE)

    def exchanges(fn, *a):
        return json.dumps([
            ["all_gather" if "all_gather" in nm else "ppermute",
             list(shape), dtype]
            for nm, shape, dtype in collectives_in_jaxpr(fn, *a)
            if "all_gather" in nm or "ppermute" in nm])

    # Output and, with grads, the gradients of sum(sin(out)) (or, per row
    # of rows, of that row's sum(sin)) in one compile, from the forward's
    # VJP; with tape, the exchange collectives of the forward and of the
    # gradient.
    def run(name, fn, a, grads=True, tape=False, rows=None):
        if grads:
            def fwd_bwd(*b):
                o, vjp = jax.vjp(fn, *b)
                ct = jnp.cos(o)
                if rows is None:
                    return o, vjp(ct)
                return o, [vjp(jnp.zeros_like(ct).at[:, r].set(ct[:, r]))
                           for r in rows]
            o, gs = jax.jit(fwd_bwd)(*a)
            for key, g in ([(name, gs)] if rows is None else
                           [(f"{name}/{r}", g) for r, g in zip(rows, gs)]):
                for i, gi in enumerate(g):
                    out[f"{key}/g{i}"] = np.asarray(gi)
        else:
            o = jax.jit(fn)(*a)
        out[name + "/out"] = np.asarray(o)
        if tape:
            out[name + "/tape"] = exchanges(fn, *a)
            gfn = jax.grad(lambda *b: jnp.sum(jnp.sin(fn(*b))),
                           argnums=tuple(range(len(a))))
            out[name + "/grad_tape"] = exchanges(gfn, *a)

    def counters(name, fn, a):
        # The reference counts once per trace of a call site.
        before = [obs.counter(c).value for c in COUNTERS]
        jax.make_jaxpr(fn)(*a)
        out[name + "/counters"] = np.array(
            [obs.counter(c).value - b for c, b in zip(COUNTERS, before)])

    for k in KS:
        mesh = make_sp_mesh(k)
        for s in ("auto", "ppermute", "allgather"):
            run(f"{k}/dirs/{s}", lambda *a, s=s: G.directional_scan(
                *a, G.DIRECTIONS, impl="sp", mesh=mesh, sp_strategy=s),
                args("dirs"))
        for h in (19, 9):
            for s in ("ppermute", "allgather"):
                run(f"{k}/edge/{h}/{s}", lambda *a, s=s: gspn_scan_sp(
                    *a, mesh=mesh, strategy=s), args(f"edge/{h}"),
                    rows=(0, h - 1))
        for i in (0, 1):
            run(f"{k}/pair/{i}", lambda *a: gspn_scan_sp_pair(
                *a, mesh=mesh), args(f"pair/{i}"), tape=True)
            run(f"{k}/pair/{i}/allgather", lambda *a: gspn_scan_sp_pair(
                *a, mesh=mesh, strategy="allgather"), args(f"pair/{i}"),
                grads=False, tape=True)
        for m in ("overlap", "serial", "skip"):
            run(f"{k}/modes/{m}", lambda *a, m=m: gspn_scan_sp_pair(
                *a, mesh=mesh, exchange_mode=m), args("modes"),
                grads=m == "serial", tape=m == "skip")
        for s in ("ppermute", "allgather"):
            for wire in ("float32", "bfloat16"):
                run(f"{k}/wire/{s}/{wire}", lambda *a, s=s, wire=wire:
                    gspn_scan_sp(*a, mesh=mesh, strategy=s,
                                 boundary_dtype=wire),
                    args("wire"), grads=False, tape=True)
        run(f"{k}/wire/pair/bfloat16", lambda *a: gspn_scan_sp_pair(
            *a, mesh=mesh, boundary_dtype="bfloat16"), args("pair/0"),
            grads=False)
        for name, fn, prefix in (
                ("ppermute", lambda *a: gspn_scan_sp(
                    *a, mesh=mesh, strategy="ppermute"), "wire"),
                ("allgather", lambda *a: gspn_scan_sp(
                    *a, mesh=mesh, strategy="allgather",
                    boundary_dtype="bfloat16"), "wire"),
                ("pair", lambda *a: gspn_scan_sp_pair(*a, mesh=mesh),
                 "pair/0"),
                ("pair_bf16", lambda *a: gspn_scan_sp_pair(
                    *a, mesh=mesh, boundary_dtype="bfloat16"), "pair/0"),
                ("pair_skip", lambda *a: gspn_scan_sp_pair(
                    *a, mesh=mesh, exchange_mode="skip"), "pair/0")):
            counters(f"{k}/counters/{name}", fn, args(prefix))
        acfg = G.GSPNAttentionConfig(dim=16, proxy_dim=2, impl="sp")
        aparams = {n[5:]: jnp.asarray(inp[n]) for n in inp
                   if n.startswith("attn/")}
        out[f"{k}/layers/attn/out"] = np.asarray(jax.jit(
            lambda x: G.apply_gspn_attention(aparams, x, acfg, mesh=mesh))(
                jnp.asarray(inp["layers/xv"])))
        scfg = G.GSPNSeqConfig(dim=16, proxy_dim=2, row_width=8, impl="sp")
        mparams = {n[6:]: jnp.asarray(inp[n]) for n in inp
                   if n.startswith("mixer/")}
        out[f"{k}/layers/mixer/out"] = np.asarray(jax.jit(
            lambda x: G.apply_gspn_seq_mixer(mparams, x, scfg, mesh=mesh))(
                jnp.asarray(inp["layers/xt"])))
        vcfg = GSPNVisionConfig(name="t", img_size=16, n_classes=4,
                                dims=(8, 12), depths=(1, 1), proxy_dim=2,
                                impl="sp")
        tree = jax.tree.structure(jax.eval_shape(
            lambda key: init_vision(key, vcfg), jax.random.PRNGKey(0)))
        vparams = jax.tree.unflatten(tree, [
            jnp.asarray(inp[f"vision_leaf/{i}"])
            for i in range(tree.num_leaves)])
        ctx = Ctx(mesh=mesh)
        out[f"{k}/layers/vision/out"] = np.asarray(jax.jit(
            lambda p, x: apply_vision(p, x, vcfg, ctx=ctx))(
                vparams, jnp.asarray(inp["layers/img"])))
    if 4 in KS:
        mesh = make_mesh((2, 2), ("data", "seq"), devices=jax.devices()[:4])
        run("hybrid", lambda *a: gspn_scan_sp(*a, mesh=mesh),
            args("hybrid"), tape=True)
    np.savez(OUT, **out)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(k: int, inputs, out):
    port = _free_port()
    env = dict(os.environ, WORLD_SIZE=str(k), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(inputs), str(out)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(k)]


def _join(procs, timeout=300):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, log[-3000:]) for p, log in zip(procs, logs)
           if p.returncode]
    assert not bad, bad


@pytest.fixture(scope="module")
def runs(run_sub, tmp_path_factory):
    """Every case through the reference and through the port's K = 2 and
    K = 4 gloo groups (the reference and the ranks run side by side)."""
    d = tmp_path_factory.mktemp("sp")
    inputs = d / "inputs.npz"
    np.savez(inputs, **make_inputs())
    procs = {k: _start_ranks(k, inputs, d / f"torch{k}.npz") for k in (2, 4)}
    # The reference at each K in a subprocess of its own, side by side.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        refs = [pool.submit(
            run_sub, f"IN, OUT, KS = {str(inputs)!r}, "
                     f"{str(d / f'jax{k}.npz')!r}, ({k},)\n"
                     + textwrap.dedent(JAX_BODY), timeout=600)
            for k in (2, 4)]
    try:
        for ref in refs:
            ref.result()
    finally:
        for k in procs:
            _join(procs[k])
    ref = {**np.load(d / "jax2.npz"), **np.load(d / "jax4.npz")}
    return {"jax": ref, 2: np.load(d / "torch2.npz"),
            4: np.load(d / "torch4.npz")}


def _check_case(mine, ref, name):
    """Output and the five gradients of case ``name`` against the
    reference's."""
    _close(mine[f"{name}/out"], ref[f"{name}/out"])
    for i in range(5):
        _close(mine[f"{name}/g{i}"], ref[f"{name}/g{i}"])


def _tape(arr):
    return sorted(map(tuple, (
        (kind, tuple(shape), dtype) for kind, shape, dtype
        in json.loads(str(arr)))))


# ---------------------------------------------------------------------------
# Spawned: the port's K gloo ranks against the reference's K devices.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("strategy", ["auto", "ppermute", "allgather"])
def test_sp_all_directions_match_jax(runs, k, strategy):
    """All four directions through ``directional_scan`` (the pairs fused
    under auto), cpw 3, H = 21 and W = 12 that K does not divide: forward
    and the five gradients."""
    _check_case(runs[k], runs["jax"], f"{k}/dirs/{strategy}")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("h", [19, 9])
@pytest.mark.parametrize("edge", ["first", "last"])
@pytest.mark.parametrize("strategy", ["ppermute", "allgather"])
def test_sp_gradients_at_grid_edges_match_jax(runs, k, h, edge, strategy):
    """A loss on the first or the last row only, compact cpw 3, heights
    whose last blocks are partly or wholly padding."""
    row = 0 if edge == "first" else h - 1
    mine, ref = runs[k], runs["jax"]
    for i in range(5):
        _close(mine[f"{k}/edge/{h}/{row}/{strategy}/g{i}"],
               ref[f"{k}/edge/{h}/{strategy}/{row}/g{i}"])


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", [0, 1])
def test_sp_fused_pair_matches_jax_with_one_collective(runs, k, case):
    """The fused pair at cpw 3 (H = 21) and cpw 1 (H = 24): forward and
    gradients; one exchange collective forward and two with the gradient,
    no point-to-point message, the same payloads as the reference's
    jaxpr; the per-direction fallback: two gathers a direction."""
    _check_case(runs[k], runs["jax"], f"{k}/pair/{case}")
    mine, ref = runs[k], runs["jax"]
    for tape in ("tape", "grad_tape"):
        got = _tape(mine[f"{k}/pair/{case}/{tape}"])
        assert got == _tape(ref[f"{k}/pair/{case}/{tape}"])
        assert [c[0] for c in got] == ["all_gather"] * (
            1 if tape == "tape" else 2)
    fallback = f"{k}/pair/{case}/allgather"
    _close(mine[fallback + "/out"], ref[fallback + "/out"])
    assert _tape(mine[fallback + "/tape"]) == _tape(ref[fallback + "/tape"])
    assert [c[0] for c in _tape(mine[fallback + "/tape"])] == \
        ["all_gather"] * 4


@pytest.mark.parametrize("k", [2, 4])
def test_sp_pair_exchange_modes_match_jax(runs, k):
    """serial is overlap bit for bit (and its gradient holds); skip
    exchanges nothing and is wrong across blocks, as the reference's."""
    mine, ref = runs[k], runs["jax"]
    _close(mine[f"{k}/modes/overlap/out"], ref[f"{k}/modes/overlap/out"])
    np.testing.assert_array_equal(mine[f"{k}/modes/serial/out"],
                                  mine[f"{k}/modes/overlap/out"])
    _check_case(mine, ref, f"{k}/modes/serial")
    _close(mine[f"{k}/modes/skip/out"], ref[f"{k}/modes/skip/out"])
    assert _tape(mine[f"{k}/modes/skip/tape"]) == []
    assert not np.allclose(mine[f"{k}/modes/skip/out"],
                           ref[f"{k}/modes/overlap/out"], atol=1e-3)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("strategy", ["ppermute", "allgather"])
def test_sp_bf16_wire_matches_jax(runs, k, strategy):
    """The bf16 wire rounds the payloads as the reference's does: within
    1e-2 of its output, each strategy off the f32 wire by a real but
    bounded amount, the f32 wire exact; the exchange payloads cross in
    bf16."""
    mine, ref = runs[k], runs["jax"]
    name = f"{k}/wire/{strategy}"
    _close(mine[name + "/float32/out"], ref[name + "/float32/out"])
    _close(mine[name + "/bfloat16/out"], ref[name + "/bfloat16/out"],
           TOL_BF16)
    exact = mine[name + "/float32/out"]
    err = np.abs(mine[name + "/bfloat16/out"] - exact).max()
    assert 1e-6 < err < 0.03, err
    assert {c[2] for c in _tape(mine[name + "/bfloat16/tape"])
            if c[1] != (3, 2, 8)} == {"bfloat16"}
    _close(mine[f"{k}/wire/pair/bfloat16/out"],
           ref[f"{k}/wire/pair/bfloat16/out"], TOL_BF16)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("call", ["ppermute", "allgather", "pair",
                                  "pair_bf16", "pair_skip"])
def test_sp_counters_and_collectives_match_jax(runs, k, call):
    """The ``sp_*`` counters of one call equal the reference's, and the
    per-direction strategies' exchange collectives equal its jaxpr's: a
    chain of K-1 hops of one boundary column, or two gathers (operator
    and boundary)."""
    mine, ref = runs[k], runs["jax"]
    np.testing.assert_array_equal(mine[f"{k}/counters/{call}/counters"],
                                  ref[f"{k}/counters/{call}/counters"])
    if call in ("ppermute", "allgather"):
        name = f"{k}/wire/{call}/float32/tape"
        got = _tape(mine[name])
        assert got == _tape(ref[name])
        assert got == ([("ppermute", (6, 8), "float32")] * (k - 1)
                       if call == "ppermute" else
                       sorted([("all_gather", (2, 8, 8), "float32"),
                               ("all_gather", (6, 8), "float32")]))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layer", ["attn", "mixer", "vision"])
def test_sp_layer_wiring_matches_jax(runs, k, layer):
    """The attention module (14 x 14), the sequence mixer (L = 100 folded
    to 13 x 8, both passes sharded) and a small vision backbone through
    its ``ctx`` mesh, each with the reference's parameters, against the
    reference under impl="sp" on the same K (1e-4 for the backbone's
    logits, as the reference holds its own)."""
    tol = 1e-4 if layer == "vision" else TOL
    _close(runs[k][f"{k}/layers/{layer}/out"],
           runs["jax"][f"{k}/layers/{layer}/out"], tol)
    assert _tape(runs[k][f"{k}/layers/{layer}/tape"])


@pytest.mark.parametrize("k", [2, 4])
def test_sp_vision_loss_gradients_match_unsharded(runs, k):
    """The small backbone's loss and every parameter's gradient under
    impl="sp" against the same model unsharded."""
    mine = runs[k]
    pre = f"{k}/vision_train"
    names = [n[len(pre) + 4:] for n in mine.files
             if n.startswith(pre + "/sp/")]
    assert len(names) > 10
    for n in names:
        _close(mine[f"{pre}/sp/{n}"], mine[f"{pre}/plain/{n}"])


def test_sp_hybrid_data_seq_mesh_matches_jax(runs):
    """A 2 x 2 ("data", "seq") mesh, G = 8 and G_w = 4 sharded over data:
    forward and gradients against the reference on the same mesh; the
    exchange carries only the data shard's boundary column (G/2, W),
    never an activation."""
    _check_case(runs[4], runs["jax"], "hybrid")
    assert _tape(runs[4]["hybrid/tape"]) == [("ppermute", (4, 16),
                                               "float32")]
    assert _tape(runs[4]["hybrid/grad_tape"]) == sorted(
        [("ppermute", (4, 16), "float32")] * 2
        + [("ppermute", (3, 2, 16), "float32")])


# ---------------------------------------------------------------------------
# In process.
# ---------------------------------------------------------------------------

def _operands(cpw, seed=0, gw=2, h=7, w=6):
    rng = np.random.default_rng(seed)
    d = _single(rng, gw, cpw, h, w)
    d["b"] = rng.standard_normal((gw * cpw, w)).astype(np.float32)
    d["t"] = rng.standard_normal((gw, w, w)).astype(np.float32)
    return d


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cpw", [1, 3])
@pytest.mark.parametrize("op", ["block_transfer_operator",
                                "block_boundary_states",
                                "propagate_boundary"])
def test_block_operators_match_jax(op, cpw, reverse):
    d = _operands(cpw)
    taps = ("wl", "wc", "wr")
    names = {"block_transfer_operator": taps,
             "block_boundary_states": ("x", *taps, "lam"),
             "propagate_boundary": ("b", *taps)}[op]
    got = getattr(sp, op)(*(torch.from_numpy(d[n]) for n in names),
                          reverse=reverse)
    want = getattr(jsp, op)(*(jnp.asarray(d[n]) for n in names),
                            reverse=reverse)
    for a, b in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert a.dtype == torch.float32
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cpw", [1, 3])
def test_apply_transfer_matches_jax(cpw):
    d = _operands(cpw)
    _close(sp._apply_transfer(torch.from_numpy(d["t"]),
                              torch.from_numpy(d["b"]), cpw).numpy(),
           np.asarray(jsp._apply_transfer(jnp.asarray(d["t"]),
                                          jnp.asarray(d["b"]), cpw)))


def test_strategy_rule_is_the_reference_rule():
    for n in range(1, 17):
        for pair in (False, True):
            assert sp.SPConfig(n_blocks=n).resolved_strategy(pair=pair) == \
                jsp.SPConfig(n_blocks=n).resolved_strategy(pair=pair)
        for s in sp.STRATEGIES:
            for pair in (False, True):
                assert sp.SPConfig(n_blocks=n, strategy=s).resolved_strategy(
                    pair=pair) == jsp.SPConfig(
                        n_blocks=n, strategy=s).resolved_strategy(pair=pair)
    assert (sp.STRATEGIES, sp.EXCHANGE_MODES, sp.PPERMUTE_MAX_BLOCKS) == \
        (jsp.STRATEGIES, jsp.EXCHANGE_MODES, jsp.PPERMUTE_MAX_BLOCKS)
    args = [torch.zeros(2, 4, 4)] * 5
    with pytest.raises(ValueError, match="strategy"):
        sp.gspn_scan_sp(*args, strategy="ring")
    with pytest.raises(ValueError, match="exchange mode"):
        sp.gspn_scan_sp_pair(args[0], *[torch.zeros(2, 2, 4, 4)] * 4,
                             exchange_mode="eager")


@pytest.fixture
def one_rank_mesh():
    """A ``("seq",)`` mesh of one block over a one-rank gloo group."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        yield make_sp_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("chunk", [None, 3])
def test_single_block_is_the_unsharded_scan(one_rank_mesh, chunk):
    """One block (or ``chunk``, which crosses no block) is ``ops``' own
    call with impl="auto", bit for bit, as the reference's fallback is
    its plain path; no collective is issued."""
    rng = np.random.default_rng(3)
    single = {k: torch.from_numpy(v) for k, v in
              _single(rng, 2, 3, 9, 8).items()}
    pair = {k: torch.from_numpy(v) for k, v in
            _pair(rng, 2, 3, 9, 8).items()}
    for mesh in (one_rank_mesh, None):
        got, tape = sp.collectives(sp.gspn_scan_sp,
                                   *(single[n] for n in FIVE), mesh=mesh,
                                   chunk=chunk)
        assert tape == []
        assert torch.equal(got, ops.gspn_scan(*(single[n] for n in FIVE),
                                              chunk=chunk))
        got = sp.gspn_scan_sp_pair(*(pair[n] for n in FIVE), mesh=mesh,
                                   chunk=chunk)
        assert torch.equal(got, ops.gspn_scan_pair(
            *(pair[n] for n in FIVE), chunk=chunk))
    want = jsp.gspn_scan_sp(*(jnp.asarray(single[n].numpy()) for n in FIVE),
                            chunk=chunk)
    _close(ops.gspn_scan(*(single[n] for n in FIVE), impl="sp",
                         mesh=one_rank_mesh, chunk=chunk).numpy(),
           np.asarray(want))
