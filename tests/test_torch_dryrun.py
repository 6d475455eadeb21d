"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

* The helpers copied rule for rule (``applicable``, ``_model_flops``,
  ``_reduced_cfg``, ``_slstm_correction`` and ``_save_cell``'s file name)
  equal the reference's on every (arch, shape).  The reference's module
  rewrites ``XLA_FLAGS`` to 512 devices when it is imported, so it is
  imported only in a subprocess of its own.
* ``run_cell`` on every smoke config and kind over fake (2, 2) and (1, 4)
  worlds, in a subprocess (the fake process group must not meet another
  world): every cell is ``ok`` with positive flops, bytes and peak; the
  ns = 2 / 4 extrapolation equals a direct count at ns = 3; each cell's
  per-rank ``arg_bytes`` equal the reference's rules' shard shapes
  (``NamedSharding.shard_shape`` on 4 forced host devices, with the
  reference's unbound ``tp`` bound to "model", see
  ``tests/test_torch_multidevice.py``).
* The sLSTM recurrence is counted once: the body once plus
  ``_slstm_correction``, against the whole loop walked.
* Importing the module sets no environment variable and starts no process
  group, and a cell refuses to start inside an initialised one.
"""

import json
import os

import pytest

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core._tree import tree_flatten
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES, ShapeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

ARCHS = ("codeqwen1.5-7b", "internlm2-20b", "qwen3-32b", "qwen2-72b",
         "xlstm-350m", "zamba2-7b", "phi3.5-moe-42b-a6.6b", "arctic-480b",
         "internvl2-1b", "whisper-base")
MESHES = ((2, 2), (1, 4))
# Small shapes of each kind for the smoke configs (the published shapes'
# 4k-32k sequences are for the card's machine); B = 1 folds the data axes
# into the cache's sequence sharding, as long_500k does.
TEST_SHAPES = {
    "train": ShapeConfig("train_t", 64, 8, "train"),
    "prefill": ShapeConfig("prefill_t", 64, 8, "prefill"),
    "decode": ShapeConfig("decode_t", 64, 8, "decode"),
    "decode_b1": ShapeConfig("decode_b1", 128, 1, "decode"),
}
B1_ARCHS = ("xlstm-350m", "zamba2-7b")     # long_500k's families


def _cells():
    for mesh in MESHES:
        for arch in ARCHS:
            for kind in TEST_SHAPES:
                if kind != "decode_b1" or arch in B1_ARCHS:
                    yield mesh, arch, kind


def _id(mesh, arch, kind):
    return f"{mesh[0]}x{mesh[1]}-{arch}-{kind}"


CELLS = list(_cells())

REFERENCE_HELPERS = r"""
import json, os, tempfile
import repro.launch.dryrun as rd
from repro.configs import get_config
from repro.models.config import SHAPES

out = {}
tmp = tempfile.mkdtemp()
rd.ARTIFACT_DIR = tmp
for arch in %(archs)r:
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        out[f"{arch}/{name}"] = [rd.applicable(cfg, shape),
                                 rd._model_flops(cfg, shape),
                                 rd._slstm_correction(cfg, shape)]
    for ns in (2, 3, 4):
        r = rd._reduced_cfg(cfg, ns)
        out[f"{arch}/ns{ns}"] = [r.n_layers, r.scan_layers,
                                 r.encoder_layers, r.n_super]
    for name in SHAPES:
        for mesh in ("16x16", "2x16x16"):
            rd._save_cell({"arch": arch, "shape": name, "mesh": mesh,
                           "status": "skip"})
out["files"] = sorted(os.listdir(tmp))
print("HELPERS" + json.dumps(out))
"""

REFERENCE_SHARDS = r"""
import dataclasses, json
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.launch.sharding as rs
rs.tp = "model"          # the rule's unbound name (see the module docstring)
from repro.configs import get_smoke_config
from repro.launch import steps
from repro.models.config import ShapeConfig

def nbytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shards = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(leaves) == len(shards), (len(leaves), len(shards))
    return int(sum(np.prod(s.shard_shape(l.shape), dtype=np.int64)
                   * l.dtype.itemsize for l, s in zip(leaves, shards)))

devs = np.array(jax.devices()[:4])
out = {}
for (mesh_shape, arch, kind) in %(cells)r:
    name, seq, batch, k = %(shapes)r[kind]
    shape = ShapeConfig(name, seq, batch, k)
    mesh = Mesh(devs.reshape(mesh_shape), ("data", "model"))
    cfg = get_smoke_config(arch)
    if k == "decode":
        cfg = dataclasses.replace(cfg, scan_layers=False,
                                  cache_dtype="float8_e4m3fn")
    params = steps.params_struct(cfg)
    pshard = rs.param_shardings(params, cfg, mesh)
    total = nbytes(params, pshard)
    named = lambda specs: {n: NamedSharding(mesh, s) for n, s in specs.items()}
    if k == "train":
        opt = steps.opt_state_struct(cfg, params)
        total += nbytes(opt, rs.opt_state_shardings(opt, pshard, mesh))
        data = steps.batch_struct(cfg, shape)
        specs = named(rs.batch_specs(cfg, mesh, kind="train"))
        total += nbytes(data, {n: specs[n] for n in data})
    else:
        states = steps.decode_state_struct(cfg, shape)
        total += nbytes(states, rs.state_specs(cfg, mesh, states,
                                                batch=shape.global_batch))
        if k == "prefill":
            data = steps.batch_struct(cfg, shape)
            data.pop("labels", None)
            specs = named(rs.batch_specs(cfg, mesh, kind="prefill"))
            total += nbytes(data, {n: specs[n] for n in data})
        else:
            token, pos = steps.decode_inputs_struct(cfg, shape)
            dp = rs.dp_axes(mesh)
            b_ok = shape.global_batch %% rs.axis_size(mesh, dp) == 0
            total += nbytes([token, pos], [
                NamedSharding(mesh, P(dp if b_ok else None, None)),
                NamedSharding(mesh, P())])
    out["%%dx%%d-%%s-%%s" %% (mesh_shape[0], mesh_shape[1], arch, kind)] = total
print("SHARDS" + json.dumps(out))
"""

PORT_CELLS = r"""
import json, sys, os, time
import torch.distributed as dist
env = dict(os.environ)
from repro_torch.launch import dryrun
from repro_torch.configs import get_smoke_config
from repro_torch.models.config import ShapeConfig
assert dict(os.environ) == env, "importing the dry-run changed the environment"
assert not dist.is_initialized()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
assert not bad, bad

shapes = {k: ShapeConfig(*v) for k, v in %(shapes)r.items()}
out = {"cells": {}}
for (mesh, arch, kind) in %(cells)r:
    key = "%%dx%%d-%%s-%%s" %% (mesh[0], mesh[1], arch, kind)
    try:
        out["cells"][key] = dryrun.run_cell(
            arch, shapes[kind], multi_pod=False, save=False, verbose=False,
            mesh_shape=tuple(mesh), smoke=True)
    except Exception as e:
        out["cells"][key] = {"status": "fail",
                             "error": f"{type(e).__name__}: {e}"[:500]}
    assert not dist.is_initialized()

# The ns = 2 / 4 extrapolation against a direct count at ns = 3.
out["ns"] = {}
for arch, kind in %(extrap)r:
    cfg = get_smoke_config(arch)
    with dryrun.fake_world(4):
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        out["ns"][f"{arch}-{kind}"] = {
            ns: dryrun._measure(dryrun._reduced_cfg(cfg, ns), shapes[kind],
                                mesh) for ns in (2, 3, 4)}

# A cell refuses to start inside an initialised process group.
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    dryrun.run_cell("qwen3-32b", shapes["train"], multi_pod=False, save=False,
                    verbose=False, mesh_shape=(1, 1), smoke=True)
    out["refused"] = False
except RuntimeError as e:
    out["refused"] = "already initialised" in str(e)
dist.destroy_process_group()
print("CELLS" + json.dumps(out))
"""

EXTRAP = (("zamba2-7b", "train"), ("qwen3-32b", "prefill"),
          ("phi3.5-moe-42b-a6.6b", "decode"))


def _shapes():
    return {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in TEST_SHAPES.items()}


def _payload(text, tag):
    return json.loads(text.split(tag, 1)[1].strip().splitlines()[0])


@pytest.fixture(scope="module")
def ref_helpers(subproc):
    return _payload(subproc(REFERENCE_HELPERS % {"archs": ARCHS}, devices=1),
                    "HELPERS")


@pytest.fixture(scope="module")
def ref_shards(subproc):
    return _payload(subproc(REFERENCE_SHARDS % {
        "cells": CELLS, "shapes": _shapes()}, devices=4), "SHARDS")


@pytest.fixture(scope="module")
def port(subproc):
    return _payload(subproc(PORT_CELLS % {
        "cells": CELLS, "shapes": _shapes(), "extrap": EXTRAP},
        devices=1, timeout=900), "CELLS")


@pytest.mark.parametrize("arch", ARCHS)
def test_helpers_match_reference(ref_helpers, arch, tmp_path, monkeypatch):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        want = ref_helpers[f"{arch}/{name}"]
        assert [dryrun.applicable(cfg, shape), dryrun._model_flops(cfg, shape),
                dryrun._slstm_correction(cfg, shape)] == want, name
    for ns in (2, 3, 4):
        r = dryrun._reduced_cfg(cfg, ns)
        assert [r.n_layers, r.scan_layers, r.encoder_layers,
                r.n_super] == ref_helpers[f"{arch}/ns{ns}"]
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    for name in SHAPES:
        for mesh in ("16x16", "2x16x16"):
            dryrun._save_cell({"arch": arch, "shape": name, "mesh": mesh,
                               "status": "skip"})
    want = [f for f in ref_helpers["files"] if f.startswith(f"{arch}__")]
    assert sorted(os.listdir(tmp_path)) == want and len(want) == 8


def test_every_arch_is_covered():
    assert set(ARCHS) == {get_config(a).name for a in list_archs()}


@pytest.mark.parametrize("mesh,arch,kind", CELLS,
                         ids=[_id(*c) for c in CELLS])
def test_run_cell_on_fake_world(port, ref_shards, mesh, arch, kind):
    """Every kind is ``ok`` with positive per-rank flops, bytes and peak, a
    bottleneck and ``fits``; its ``arg_bytes`` are the reference's rules'
    shard bytes."""
    key = _id(mesh, arch, kind)
    cell = port["cells"][key]
    assert cell["status"] == "ok", cell.get("error")
    for k in ("flops_per_device", "bytes_per_device", "peak_bytes",
              "arg_bytes"):
        assert cell[k] > 0, k
    assert cell["peak_bytes"] >= cell["arg_bytes"]
    assert cell["bottleneck"] in ("compute", "memory", "collective")
    assert cell["fits"] is True
    assert cell["n_chips"] == 4 and cell["mesh"] == f"{mesh[0]}x{mesh[1]}"
    for rec in cell["collectives"].values():
        assert rec["count"] >= 0 and rec["bytes"] >= 0
    assert cell["arg_bytes"] == ref_shards[key]


@pytest.mark.parametrize("arch,kind", EXTRAP)
def test_extrapolation_equals_direct_count(port, arch, kind):
    """The reference's linear extrapolation from ns = 2 and 4 superblocks
    gives the direct count at ns = 3: flops, bytes, peak, and each
    collective kind's count and bytes."""
    ms = port["ns"][f"{arch}-{kind}"]
    m2, m3, m4 = ms["2"], ms["3"], ms["4"]
    for key in ("flops", "bytes", "coll_bytes", "peak_bytes", "out_bytes"):
        assert (m2[key] + m4[key]) / 2 == pytest.approx(m3[key], rel=1e-12), key
    assert m3["flops"] > m2["flops"] > 0
    kinds = set(m2["collectives"]) | set(m4["collectives"])
    assert kinds == set(m3["collectives"]) and kinds
    for kind_ in kinds:
        for f in ("count", "bytes"):
            a, b = (m["collectives"].get(kind_, {f: 0})[f] for m in (m2, m4))
            assert (a + b) / 2 == m3["collectives"][kind_][f], (kind_, f)


def test_run_cell_refuses_an_initialised_world(port):
    assert port["refused"] is True


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_slstm_recurrence_counted_once(kind):
    """xLSTM's sLSTM loop: the dry-run counts its body once and adds
    ``_slstm_correction``, as the reference adds it to XLA's once-counted
    ``while`` body.  Against the loop walked whole (every step counted):
    a prefill's total exceeds it by exactly one step's body, far from a
    second copy of the recurrence; a train step's differs by the remat
    recompute's step bodies the reference's factor 3 leaves out."""
    b, seq = 2, 32
    shape = ShapeConfig(f"{kind}_s", seq, b, kind)
    cfg = get_smoke_config("xlstm-350m")
    once = dryrun.count_step("xlstm-350m", shape, smoke=True)["flops"]
    walk = dryrun.count_step("xlstm-350m", shape, smoke=True,
                             once=False)["flops"]
    corr = dryrun._slstm_correction(cfg, shape)
    total = once + corr
    assert corr > 0 and walk > once
    if kind == "prefill":
        body = corr / seq                       # one step, every layer
        assert total - walk == pytest.approx(body, rel=1e-9)
    else:
        # fwd + recompute + bwd walk 4 bodies a step; the correction 3.
        body = corr / (3 * seq)
        assert total - walk == pytest.approx((4 - seq) * body, rel=1e-9)
    assert abs(total - walk) < corr / 2     # counted twice: walk + corr


def test_decode_runs_on_meta_tensors():
    """A decode step on meta tensors (a meta ``pos``: read on the device,
    never on the host) runs for an attention config and a hybrid."""
    shape = ShapeConfig("decode_s", 64, 2, "decode")
    for arch in ("qwen3-32b", "zamba2-7b"):
        got = dryrun.count_step(arch, shape, smoke=True)
        assert got["flops"] > 0 and got["peak_bytes"] >= got["arg_bytes"] > 0


def test_import_starts_nothing():
    """Importing the module in this process set no environment variable
    for JAX and started no process group (the subprocess above checks
    the whole environment before and after)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert "512" not in os.environ.get("XLA_FLAGS", "")


def test_unknown_config_raises_the_reference_type():
    """An unknown name raises ``ModuleNotFoundError``, the reference's
    ``import_module`` error, with the port's message."""
    from repro import configs as ref_configs
    from repro_torch import configs

    with pytest.raises(ModuleNotFoundError) as ref:
        ref_configs.get_config("gpt-5")
    with pytest.raises(ModuleNotFoundError, match="no config 'gpt-5'") as got:
        configs.get_config("gpt-5")
    assert type(got.value) is type(ref.value)
    with pytest.raises(ModuleNotFoundError, match="no config"):
        configs.get_smoke_config("gpt-5")


@pytest.mark.parametrize("arch", ["qwen3-32b", "zamba2-7b"])
def test_decode_pos_as_a_tensor_is_bit_equal(arch):
    """``attention_decode`` builds its positions from ``pos`` on the device:
    a 0-d tensor ``pos`` gives the int's logits and caches bit for bit."""
    import torch

    from repro_torch.models import lm

    cfg = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    states = lm.init_decode_states(cfg, 2, 16)
    with torch.no_grad():
        _, states = lm.prefill(params, cfg, {"tokens": prompt}, states)
        tok = prompt[:, -1:]
        a, sa = lm.decode_step(params, cfg, tok, 8, states)
        b, sb = lm.decode_step(params, cfg, tok,
                               torch.tensor(8, dtype=torch.int32), states)
    assert torch.equal(a, b)
    for x, y in zip(tree_flatten(sa)[0], tree_flatten(sb)[0]):
        assert torch.equal(x, y)
