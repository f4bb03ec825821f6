"""The roofline's counting (``repro_torch.roofline.cost``), its analysis
and report, the kernels' ``meta`` path, ``input_specs`` and remat
"dots", against the reference where it has a twin.

The twins of ``tests/test_hlo_cost.py`` run on ``meta`` tensors: a loop
of matrix products counted exactly, its gradient at about 3x, under
remat "unit" at about 4x, under "dots" between the two with no product
recomputed; bytes scale with the trip count; under a fake process group
an all-reduce counts twice its payload and an all-gather its output.
Against the JAX package: the port's FLOPs of a reduced train step within
5% of ``repro.roofline.hlo_cost.analyze`` on the reference's compiled
step, ``model_flops`` and ``input_specs`` equal, remat "dots"
gradients within 1e-5 of the reference's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint

from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as jadamw_init
from repro.roofline import analysis as janalysis
from repro.roofline.hlo_cost import analyze
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch.configs import base as tbase
from repro_torch.kernels import cuda_lib, gspn_multidir, gspn_scan, ops
from repro_torch.kernels.spec import resolve_impl
from repro_torch.launch.mesh import HW
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline import analysis, cost
from repro_torch.roofline.report import render
from repro_torch.train.step import build_train_step, init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, K, N, TRIPS = 64, 128, 128, 7


def _loop(remat=None, trips=TRIPS):
    """tanh(x @ w) ``trips`` times, each step under ``remat`` ("unit":
    checkpointed; "dots": checkpointed keeping the products)."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = lm._dots_context

    def body(c, w):
        return torch.tanh(c @ w)

    def f(x, w):
        for _ in range(trips):
            x = body(x, w) if remat is None else checkpoint.checkpoint(
                body, x, w, use_reentrant=False, **kw)
        return x
    return f


def _operands():
    x = torch.empty((M, K), device="meta")
    w = torch.empty((K, N), device="meta", requires_grad=True)
    return x, w


def _grad(f):
    return lambda x, w: torch.autograd.grad(f(x, w).sum(), w)


EXPECT = 2 * M * K * N * TRIPS


def test_forward_flops_exact():
    _, res = cost.count(_loop(), *_operands())
    assert 0.99 < res["flops"] / EXPECT < 1.01
    assert res["op_census"] == {"dot": TRIPS}
    assert res["flops_by_dtype"] == {"float32": res["flops"]}


def test_grad_flops_3x():
    _, res = cost.count(_grad(_loop()), *_operands())
    assert 0.9 < res["flops"] / (3 * EXPECT) < 1.2


def test_remat_flops_4x():
    _, res = cost.count(_grad(_loop("unit")), *_operands())
    assert 3.8 < res["flops"] / EXPECT < 4.3


def test_dots_flops_between_none_and_unit_with_no_product_recomputed():
    """remat "dots" keeps every product's output: its FLOPs and products
    are those without remat (2.86x here: the first step needs no dx),
    below "unit"'s, which recomputes them."""
    runs = {r: cost.count(_grad(_loop(r)), *_operands())[1]
            for r in (None, "dots", "unit")}
    assert runs["dots"]["op_census"] == runs[None]["op_census"]
    assert runs["dots"]["flops"] == runs[None]["flops"]
    assert runs[None]["flops"] < runs["dots"]["flops"] + 1 \
        < runs["unit"]["flops"]
    assert 2.7 < runs["dots"]["flops"] / EXPECT < 4.3


def test_bytes_scale_with_trips():
    b7 = cost.count(_loop(trips=7), *_operands())[1]["bytes_hbm"]
    b14 = cost.count(_loop(trips=14), *_operands())[1]["bytes_hbm"]
    assert 1.6 < b14 / b7 < 2.2, b14 / b7


def test_peak_counts_live_storages():
    """The arguments plus, without autograd, three steps' outputs at once
    (the previous step's, the product's and tanh's; nothing that died);
    with a weight that requires grad, every tanh output, which autograd
    saves, and the last product's."""
    x, w = _operands()
    args, step = (M * K + K * N) * 4, M * N * 4
    _, res = cost.count(_loop(), x, w.detach())
    assert res["peak_bytes"] == args + 3 * step
    _, res = cost.count(_loop(), x, w)
    assert res["peak_bytes"] == args + (TRIPS + 1) * step


FAKE_GROUP = """
    import json, torch
    from repro_torch.launch import dryrun
    from repro_torch.parallel import collectives
    from repro_torch.roofline.cost import CostMode
    dryrun.fake_group(4)
    t = torch.empty((8, 16), device="meta")
    mode = CostMode()
    with mode:
        collectives.model_all_reduce(t.clone(), None)
        collectives.model_all_gather(t, None, 0)
    print(json.dumps({**mode.result()["collectives"],
                      "staged": sum(collectives.staged_bytes.values())}))
"""


def test_fake_group_collectives_count_their_ring_bytes():
    """Under the fake group (no gloo staging), an all-reduce counts twice
    its payload and an all-gather its output, once each."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(FAKE_GROUP)],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=os.path.join(
                           ROOT, "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    coll = json.loads(r.stdout.strip().splitlines()[-1])
    payload = 8 * 16 * 4
    assert coll["all-reduce"] == 2 * payload
    assert coll["all-gather"] == 4 * payload
    assert coll["total"] == 6 * payload and coll["count"] == 2
    assert coll["staged"] == 0


# ---------------------------------------------------------------------------
# Against the reference.
# ---------------------------------------------------------------------------

B, S = 2, 64


@pytest.mark.parametrize("remat", ["unit", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-1.5b-gspn"])
def test_train_step_flops_match_the_reference_hlo_count(arch, remat):
    """The port's FLOPs of one reduced train step (f32, B x S tokens,
    AdamW), counted on ``meta``, within 5% of the reference's
    trip-corrected HLO count of its compiled step (0.4-0.6% apart when
    this was written)."""
    jc = dataclasses.replace(jbase.with_precision(
        jbase.get_arch(arch).reduced(), "f32"), remat=remat)
    params = jax.eval_shape(lambda k: jlm.init_lm(k, jc),
                            jax.random.PRNGKey(0))
    ocfg = JAdamW()
    state = jax.eval_shape(lambda p: {"params": p,
                                      "opt": jadamw_init(ocfg, p)}, params)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    want = analyze(jax.jit(jbuild_train_step(jc, ocfg)).lower(
        state, batch).compile().as_text())["flops"]
    tc = dataclasses.replace(tbase.with_precision(
        tbase.get_arch(arch).reduced(), "f32"), remat=remat)
    model = lm.LM(tc, device="meta")
    step = build_train_step(model, AdamWConfig())
    tstate = init_train_state(model, AdamWConfig())
    tbatch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    got = cost.count(step, tstate, tbatch)[1]["flops"]
    print(f"{arch} remat={remat}: port {got:.0f} reference {want:.0f} "
          f"ratio {got / want:.4f}")
    assert abs(got / want - 1) < 0.05


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-1.5b-gspn"])
def test_meta_flops_equal_flop_counter_mode_on_a_real_run(arch):
    """The count on ``meta`` equals ``FlopCounterMode``'s over the same
    step run for real on the CPU (the card's check of ``chip_smoke.py``
    at full width, here reduced): the kernels' ``meta`` path and the
    plain scans add no FLOPs, and both count the same products."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(tbase.get_arch(arch).reduced(), remat="unit")
    counts = {}
    for device in ("meta", "cpu"):
        model = lm.LM(cfg, device=device)
        step = build_train_step(model, AdamWConfig())
        state = init_train_state(model, AdamWConfig())
        gen = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, 512, (B, S), generator=gen,
                                  dtype=torch.int32).to(device)
                 for k in ("tokens", "labels")}
        if device == "meta":
            counts[device] = cost.count(step, state, batch)[1]["flops"]
        else:
            with FlopCounterMode(display=False) as fc:
                step(state, batch)
            counts[device] = fc.get_total_flops()
    assert counts["meta"] == counts["cpu"] > 0


def _cells():
    from repro_torch.launch.dryrun import cell_matrix
    return cell_matrix()


def test_model_flops_match_the_reference():
    for kind, arch, shape, _ in _cells():
        if kind == "vision":
            from repro_torch.launch.lowering import VISION_SHAPES
            spec = VISION_SHAPES[shape]
            meta = {"arch": arch, "kind": spec.kind, "family": "vision",
                    "seq_len": spec.seq_len, "global_batch":
                    spec.global_batch}
        else:
            spec = tbase.SHAPES[shape]
            meta = {"arch": arch, "kind": spec.kind, "family": "lm",
                    "seq_len": spec.seq_len, "global_batch":
                    spec.global_batch}
        assert analysis.model_flops(meta) == janalysis.model_flops(meta), \
            (arch, shape)


def test_input_specs_match_the_reference():
    for arch in tbase.list_archs():
        tc, jc = tbase.get_arch(arch).full(), jbase.get_arch(arch).full()
        for name, shape in tbase.SHAPES.items():
            got = tbase.input_specs(tc, shape)
            want = jbase.input_specs(jc, jbase.SHAPES[name])
            assert list(got) == list(want), (arch, name)
            for k, t in got.items():
                assert t.is_meta
                assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
                assert str(t.dtype).removeprefix("torch.") == \
                    str(want[k].dtype), (arch, k)


def test_remat_dots_gradients_match_none_and_the_reference():
    """Under remat "dots" the gradients of reduced qwen2-1.5b's loss
    equal "none"'s within 1e-6 of each leaf's largest and the
    reference's "dots" gradients within 1e-5."""
    jc = dataclasses.replace(jbase.with_precision(
        jbase.get_arch("qwen2-1.5b").reduced(), "f32"), remat="dots")
    params = jlm.init_lm(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 24)).astype(np.int32)
    jgrads = jax.grad(lambda p: jlm.lm_loss(
        p, jc, {"tokens": jnp.asarray(toks),
                "labels": jnp.asarray(labels)})[0])(params)
    want = lm_state_from_jax(jax.tree.map(np.asarray, jgrads))
    state = lm_state_from_jax(jax.tree.map(np.asarray, params))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    grads = {}
    for remat in ("none", "dots"):
        model = lm.LM(dataclasses.replace(tbase.with_precision(
            tbase.get_arch("qwen2-1.5b").reduced(), "f32"), remat=remat),
            device="meta")
        model.load_state_dict(state, assign=True)
        loss = lm.lm_loss(model, batch)[0]
        names = [n for n, _ in model.named_parameters()]
        grads[remat] = dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters()))))
    for n, g in grads["dots"].items():
        scale = want[n].abs().max().item()
        assert (g - grads["none"][n]).abs().max().item() <= 1e-6 * scale, n
        assert (g - want[n]).abs().max().item() <= 1e-5 * scale, n


# ---------------------------------------------------------------------------
# The kernels' meta path.
# ---------------------------------------------------------------------------

def _scan_operands(device, ndir=None, g=8, h=16, w=16, cpw=2):
    lead = (ndir,) if ndir else ()
    x = torch.rand((g, h, w), device=device)
    taps = [torch.rand(lead + (g // cpw, h, w), device=device)
            for _ in range(3)]
    lam = torch.rand(lead + (g, h, w), device=device)
    return x, *taps, lam


def _operand_bytes(args, out) -> int:
    return sum(t.numel() * t.element_size() for t in (*args, out))


@pytest.mark.parametrize("kernel", ["gspn_scan_fwd", "gspn_pair_fwd",
                                    "gspn_quad_fwd"])
def test_meta_launch_records_the_shared_byte_count(kernel):
    """A ``meta`` launch of #1, #3 or #5 records one launch whose bytes
    are ``launch_cost``'s and the operands' plus the output's, and runs
    nothing; the same call on CPU tensors takes the plain version and
    records nothing."""
    fn, ndir = {"gspn_scan_fwd": (gspn_scan.gspn_scan_fwd, None),
                "gspn_pair_fwd": (gspn_multidir.gspn_scan_bidir, 2),
                "gspn_quad_fwd": (gspn_multidir.gspn_scan_quad, 4)}[kernel]
    for device in ("meta", "cpu"):
        args = _scan_operands(device, ndir)
        cuda_lib.clear_counts()
        out = fn(*args)
        if device == "cpu":
            assert cuda_lib.meta_launches == []
            assert cuda_lib.plain_calls == {kernel: 1}
            assert resolve_impl("auto", args[0]) == "torch"
            continue
        assert out.is_meta and dict(cuda_lib.launch_counts) == {}
        assert dict(cuda_lib.plain_calls) == {}
        (rec,) = cuda_lib.meta_launches
        nbytes, _ = gspn_scan.launch_cost("fwd", ndir or 1, 8, 16, 16, 2,
                                          torch.float32)
        assert rec["kernel"] == kernel and rec["bytes"] == nbytes
        assert nbytes == _operand_bytes(args, out)
        assert resolve_impl("auto", args[0]) == "meta"


def test_meta_scan_gradient_records_both_kernels():
    """The differentiable op on ``meta`` operands records #1 forward and
    #2 (its adjoint, written in f32) backward, with their bytes."""
    x, wl, wc, wr, lam = (t.requires_grad_() for t in _scan_operands("meta"))
    cuda_lib.clear_counts()
    h = ops.gspn_scan(x, wl, wc, wr, lam)
    torch.autograd.grad(h.sum(), [x, wl, lam])
    fwd, bwd = cuda_lib.meta_launches
    assert (fwd["kernel"], bwd["kernel"]) == ("gspn_scan_fwd",
                                              "gspn_scan_bwd")
    g = torch.empty((8, 16, 16), device="meta")
    assert bwd["bytes"] == _operand_bytes((g, wl, wc, wr), g)


# ---------------------------------------------------------------------------
# The analysis and the report.
# ---------------------------------------------------------------------------

def test_analysis_terms_from_the_h100_table(tmp_path):
    """A synthetic record: each dtype's FLOPs at its own peak, the bytes
    over HBM, the collectives over the link, by hand."""
    rec = {
        "arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "single",
        "status": "ok", "n_devices": 256,
        "meta": {"arch": "qwen2-1.5b", "shape": "train_4k",
                 "kind": "train", "family": "dense",
                 "seq_len": 4096, "global_batch": 256},
        "flops": 3e15, "flops_by_dtype": {"bfloat16": 2e15,
                                          "float32": 1e15},
        "bytes_hbm": 1e13, "bytes_hbm_calibrated": None,
        "collectives": {"total": 1e11, "all-reduce": 1e11, "count": 3},
    }
    (tmp_path / "x__train_4k__single.json").write_text(json.dumps(rec))
    (tmp_path / "y__decode_32k__single.json").write_text(json.dumps(
        {"arch": "y", "shape": "decode_32k", "mesh": "single",
         "status": "skipped", "reason": "rule"}))
    rows, skips, errors = analysis.analyze_dir(str(tmp_path), "single")
    assert len(rows) == 1 and len(skips) == 1 and not errors
    r = rows[0]
    compute = 2e15 / 989.4e12 + 1e15 / 66.9e12
    assert r.compute_s == pytest.approx(compute, rel=1e-12)
    assert r.memory_s == pytest.approx(1e13 / 3.35e12, rel=1e-12)
    assert r.collective_s == pytest.approx(1e11 / 50e9, rel=1e-12)
    assert r.dominant == "compute" and r.bound_s == r.compute_s
    assert HW["peak_flops_f32"] == 66.9e12 and HW["link_bw"] == 50e9
    doc = render(str(tmp_path))
    assert "qwen2-1.5b" in doc and "1 skipped" in doc
