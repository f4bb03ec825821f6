"""The dry run (``repro_torch.launch.dryrun``, ``launch.lowering``)
against the reference's, on the CPU with no card.

``--list`` prints the reference's cells and skips, and ``cell_matrix()``
equals ``repro.launch.dryrun.cell_matrix()`` (run in a subprocess: that
module forces 512 host devices at import).  A cell of reduced
``qwen2-1.5b`` runs under a fake process group of 8 ranks on (data 4,
model 2), as the reference's ``test_dryrun_cell_builds_and_compiles_small_mesh``
compiles it: it ends ``ok`` with FLOPs and a peak, and the data axis's
collective bytes are the sum that the sharding specs give.  Every LM
cell that is not skipped passes ``check_model_axis`` on the production
mesh's model axis, checked without running it, and the decode cell of
reduced whisper passes the encoder's ``enc_kv`` to ``lm_decode_step``,
as the reference's does.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import base as tbase
from repro_torch.launch.dryrun import (TOKEN_LOOP_TIMEOUT, cell_matrix,
                                      cell_timeout)
from repro_torch.parallel import tensor_parallel as tpar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")


def _run(args, timeout=300):
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, env=ENV, cwd=ROOT)
    assert r.returncode == 0, f"STDOUT:{r.stdout[-3000:]}\n" \
                              f"STDERR:{r.stderr[-3000:]}"
    return r.stdout


def test_list_and_cell_matrix_match_the_reference():
    """46 cells (44 LM, 2 vision), 8 skipped; the reference's matrix,
    order and skip reasons included."""
    lines = _run(["-m", "repro_torch.launch.dryrun", "--list"]) \
        .strip().splitlines()
    assert len(lines) == 46
    assert sum("SKIP: " in line for line in lines) == 8
    want = json.loads(_run(["-c", "import json; from repro.launch.dryrun "
                            "import cell_matrix; "
                            "print(json.dumps(cell_matrix()))"])
                      .strip().splitlines()[-1])
    got = cell_matrix()
    assert [list(c) for c in got] == want
    assert sum(c[0] == "lm" for c in got) == 44


def test_failing_cells_are_exactly_the_out_of_slice_kinds():
    """No cell fails by design: on the production mesh's model axis of
    16, ``check_model_axis`` accepts the config of every LM cell that is
    not skipped (36 cells a mesh, qwen2-vl's and whisper's 6 among
    them)."""
    checked = []
    for kind, arch, shape, skip in cell_matrix():
        if kind != "lm" or skip is not None:
            continue
        tpar.check_model_axis(tbase.get_arch(arch).full(n_model_shards=16),
                              16)
        checked.append(arch)
    assert len(checked) == 36
    assert checked.count("qwen2-vl-72b") == checked.count("whisper-base") \
        == 3


def test_sweep_gives_the_token_loop_cells_their_timeout():
    """The sweep stops each cell of xlstm-1.3b, whose sLSTM runs token by
    token on ``meta`` (its train_4k cell took 130 min on the single
    mesh), after ``TOKEN_LOOP_TIMEOUT`` times ``--timeout``, past that
    cell's time at the default; every other cell after ``--timeout``."""
    limits = {(arch, shape): cell_timeout(kind, arch, 1800)
              for kind, arch, shape, _ in cell_matrix()}
    long = {cell for cell, t in limits.items() if t != 1800}
    assert long == {("xlstm-1.3b", shape) for shape in tbase.SHAPES}
    assert {limits[cell] for cell in long} == {1800 * TOKEN_LOOP_TIMEOUT}
    assert 1800 * TOKEN_LOOP_TIMEOUT > 130 * 60


CELL = """
    import dataclasses, json, sys, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import ShapeSpec, get_arch
    from repro_torch.launch import dryrun, lowering
    from repro_torch.models import lm
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import param_shardings, sharded_dim

    out = sys.argv[1]
    dryrun.fake_group(8)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                      mesh_dim_names=("data", "model"))
    kw = dict(spec=ShapeSpec("tiny", "train", 64, 8), reduced=True,
              grad_accum=2)
    assert dryrun.run_cell("lm", "qwen2-1.5b", "tiny", "single", out,
                           mesh=mesh, **kw)
    cell = lowering.build_lm_cell("qwen2-1.5b", "tiny", mesh, **kw)
    data = sum(collectives.RING[op] * n for op, n in cell.collectives)
    # The specs' sum: each leaf's model-local bytes, gathered twice and
    # reduce-scattered once a microbatch where the data axis shards it,
    # else its f32 gradient all-reduced (2x) once a microbatch.
    cfg = dataclasses.replace(get_arch("qwen2-1.5b").reduced(),
                              n_model_shards=2)
    whole = {n: (tuple(p.shape), p.element_size(), p.numel()) for n, p in
             lm.LM(cfg, device="meta").named_parameters()}
    specs = param_shardings({n: s for n, (s, _, _) in whole.items()},
                            {"data": 4, "model": 2})
    want = 0
    for n, (shape_, item, numel) in whole.items():
        local = numel // (2 if sharded_dim(specs[n], "model") else 1)
        if sharded_dim(specs[n], "data"):
            want += 2 * (2 + 1) * local * item
        else:
            want += 2 * 2 * 4 * local
    print(json.dumps({"data": data, "want": want}))
"""


def test_dryrun_cell_on_a_fake_group_of_8(tmp_path):
    """Reduced qwen2-1.5b on (data 4, model 2), train, 8 sequences of 64,
    2 microbatches: ``ok``, FLOPs, bytes and a peak above 0, collectives
    of both axes; the data axis's bytes equal the specs' sum."""
    out = json.loads(_run(["-c", textwrap.dedent(CELL), str(tmp_path)])
                     .strip().splitlines()[-1])
    assert out["data"] == out["want"] > 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert path.name == "qwen2-1.5b__tiny__single.json"
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops"] > 0 and rec["bytes_hbm"] > 0
    assert rec["peak_bytes"] > 0 and rec["meta"]["grad_accum"] == 2
    assert rec["mesh_shape"] == {"data": 4, "model": 2}
    coll = rec["collectives"]
    assert coll["total"] > out["data"]        # the model axis's too
    assert coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    assert rec["bytes_hbm_calibrated"] is None and rec["hw"]["hbm_bw"]


DECODE = """
    import json, sys, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, lowering
    from repro_torch.models import lm

    dryrun.fake_group(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    built = []

    class OnCPU(lm.LM):
        # The cell's model on the CPU with seeded weights, kept to compare.
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
            built.append(self)

    lowering.lm_mod.LM = OnCPU
    cell = lowering.build_lm_cell(
        "whisper-base", "tiny", mesh, spec=ShapeSpec("tiny", "decode", 16, 2),
        reduced=True)
    token, caches, enc_kv = cell.args
    (model,) = built
    cfg = model.cfg
    shapes = [[list(t.shape), str(t.dtype), t.device.type] for t in enc_kv]
    resident = any(t is enc_kv[0] for t in torch.utils._pytree.tree_flatten(
        cell.resident)[0])
    g = torch.Generator().manual_seed(1)
    token = torch.randint(0, cfg.vocab, token.shape, generator=g)
    prompt = torch.randint(0, cfg.vocab, (token.shape[0], 5), generator=g)
    frames = torch.randn((token.shape[0], cfg.enc_len, cfg.d_model),
                         generator=g)
    with torch.no_grad():
        kv = lm.lm_encode(model, frames)
        _, caches = lm.lm_prefill(model, prompt, 16, enc_kv=kv)
        got, _ = cell.fn(token, caches, kv)
        want, _ = lm.lm_decode_step(model, token, caches, enc_kv=kv)
        without, _ = lm.lm_decode_step(model, token, caches)
    print(json.dumps({"shapes": shapes, "resident": resident,
                      "equal": bool(torch.equal(got, want)),
                      "cross": bool((got - without).abs().max() > 1e-3),
                      "want": [token.shape[0], cfg.enc_len, cfg.n_kv_heads,
                               cfg.hd, str(cfg.compute_dtype)]}))
"""


def test_whisper_decode_cell_takes_enc_kv():
    """The decode cell of reduced whisper (``build_lm_cell(...,
    reduced=True)``, one rank) takes ``enc_kv`` as the reference's cell
    does: two (B, enc_len, Hkv, D) tensors in the compute dtype on
    ``meta``, counted in ``resident``.  Given weights and the encoder's
    keys and values, its program returns ``lm_decode_step(enc_kv=)``'s
    logits bit for bit, which the cross-attention moves (they differ
    from the step without ``enc_kv``)."""
    out = json.loads(_run(["-c", textwrap.dedent(DECODE)])
                     .strip().splitlines()[-1])
    b, t, h, d, dtype = out["want"]
    assert out["shapes"] == [[[b, t, h, d], dtype, "meta"]] * 2
    assert out["resident"] and out["equal"] and out["cross"]
