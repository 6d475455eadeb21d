"""LM multi-device in the port, held to the reference: the sharding rules
(``launch/sharding.py``) for every full configuration at the production
meshes and (2, 2), the blocks a DTensor layout gives each rank of a (2, 2)
gloo world (``launch/mesh.py``), the ``shardctx`` anchors, int8 compressed
psums (``optim/compress.py``), elastic rescale plans
(``runtime/elastic.py``) and the sequence-sharded ``ssd_scan`` on meshes of
CPU positions (``core/spmd.py``).

The reference's multi-device values come from one subprocess with 8
virtual devices (``subproc``), on inputs this module writes with numpy
from a seed; the port's (2, 2) world is one spawn of 4 gloo ranks.

The reference's ``_spec_for`` reads a ``tp`` it never binds, so its
``param_shardings`` raises NameError on every tree; the rule tests bind
that module global to ``"model"`` (every mesh here has that axis), which
is what the rule means and what the port's copy binds.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.sharding as ref_shd
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models.config import SHAPES as REF_SHAPES
from repro.optim import compress as ref_compress
from repro.runtime import elastic as ref_elastic
from repro_torch.configs import get_config, list_archs
from repro_torch.core import spmd
from repro_torch.core._tree import tree_flatten
from repro_torch.kernels import ops
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import shardctx
from repro_torch.models.config import SHAPES
from repro_torch.optim import compress
from repro_torch.runtime import elastic

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
SSD_TOL = 1e-5          # float32 sequence-sharded scan vs reference / unsharded
PSUM_TOL = 1e-6         # float32: 8 values summed in another order, scales
                        # applied as reciprocal products (jit) or quotients
# (shape, spec) pairs laid out on the (2, 2) ("data", "model") mesh.
PLACEMENTS = [((8, 12), ["data", "model"]),
              ((3, 8, 4), [None, "data", "model"]),
              ((8, 6), [["data", "model"], None]),
              ((6, 8), [None, "data"]),
              ((4, 4), [])]


def _spec(entries):
    return spmd.P(*[tuple(e) if isinstance(e, list) else e for e in entries])


# ------------------------------------------------------------------ rules
@pytest.fixture
def ref_rules(monkeypatch):
    monkeypatch.setattr(ref_shd, "tp", "model", raising=False)
    return ref_shd


def _ref_specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(tree)]


def _port_specs(specs):
    return [tuple(s.spec) for s in tree_flatten(shd.named(None, specs))[0]]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_match_reference(arch, mesh_name, ref_rules):
    """param, opt-state, batch (train, prefill, decode, seq-shard), decode
    state and logits specs, leaf for leaf, on shape-only meshes."""
    shape, names = MESHES[mesh_name]
    rmesh, pmesh = AbstractMesh(shape, names), port_mesh.AbstractMesh(shape, names)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rparams, params = ref_steps.params_struct(rcfg), steps.params_struct(cfg)
    rps = ref_rules.param_shardings(rparams, rcfg, rmesh)
    ps = shd.param_shardings(params, cfg, pmesh)
    assert _port_specs(ps) == _ref_specs(rps)
    ropt = ref_rules.opt_state_shardings(
        ref_steps.opt_state_struct(rcfg, rparams), rps, rmesh)
    opt = shd.opt_state_shardings(steps.opt_state_struct(cfg, params), ps,
                                  pmesh)
    assert _port_specs(opt) == _ref_specs(ropt)
    for kind, seq in (("train", False), ("prefill", False), ("decode", False),
                      ("prefill", True)):
        got = shd.batch_specs(cfg, pmesh, kind=kind, seq_shard=seq)
        want = ref_rules.batch_specs(rcfg, rmesh, kind=kind, seq_shard=seq)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}, (kind, seq)
    for shape_name in ("decode_32k", "long_500k"):
        rshape, pshape = REF_SHAPES[shape_name], SHAPES[shape_name]
        rstates = ref_steps.decode_state_struct(rcfg, rshape)
        states = steps.decode_state_struct(cfg, pshape)
        got = shd.state_specs(cfg, pmesh, states, batch=pshape.global_batch)
        want = ref_rules.state_specs(rcfg, rmesh, rstates,
                                     batch=rshape.global_batch)
        assert _port_specs(got) == _ref_specs(want), shape_name
    assert tuple(shd.logits_spec(cfg, pmesh)) == tuple(
        ref_rules.logits_spec(rcfg, rmesh))


def test_mesh_axes_on_every_kind_of_mesh():
    """The rules' helpers read names and sizes from a shape-only mesh and
    an ``spmd.Mesh`` alike; a DeviceMesh needs a world of ranks."""
    for m in (port_mesh.AbstractMesh((2, 16, 16), ("pod", "data", "model")),
              spmd.Mesh(["cpu"] * 512, ("pod", "data", "model"), (2, 16, 16))):
        assert port_mesh.dp_axes(m) == ("pod", "data")
        assert port_mesh.tp_axis(m) == "model"
        assert port_mesh.axis_size(m, ("pod", "data")) == 32
        assert port_mesh.axis_size(m, None) == 1
    assert port_mesh.tp_axis(port_mesh.AbstractMesh((4,), ("data",))) is None
    assert port_mesh.production_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="need 256 devices, have 1"):
        port_mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        elastic.build_mesh(elastic.plan_rescale(4, model_parallel=1),
                           device="cpu")


def test_placements_follow_mesh_order():
    m = port_mesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard

    assert shd.placements(spmd.P(None, ("pod", "data"), "model"), m) == [
        Shard(1), Shard(1), Shard(2)]
    assert shd.placements(spmd.P(), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        shd.placements(spmd.P(("data", "pod")), m)
    with pytest.raises(NameError, match="unbound"):
        shd.placements(spmd.P("x"), m)
    assert spmd.P(("data",), None) == ("data", None)


# ------------------------------------------------------------ shardctx
def test_shardctx_is_identity_without_a_mesh():
    xs = [torch.ones(2, 3, 4), torch.ones(2, 3, 4, 5), torch.ones(6, 8),
          torch.ones(3)]
    for x in xs:
        assert shardctx.constrain_tokens_major(x) is x
        assert shardctx.constrain_heads(x) is x
        assert shardctx.constrain_vocab_chunk(x) is x
        assert shardctx.gather_seq(x) is x
        assert shardctx.seq_gathered_grad(x) is x
        assert shardctx.local_heads(lambda t: t, x) is x
    # A context with plain tensors (one device) changes nothing either.
    with shardctx.activation_sharding(port_mesh.AbstractMesh((2, 2), (
            "data", "model")), dp=("data",), tp="model"):
        for x in xs:
            assert shardctx.constrain_tokens_major(x) is x
            assert shardctx.constrain_heads(x) is x
            assert shardctx.constrain_vocab_chunk(x) is x
        assert shardctx.current()["tp"] == "model"
    assert shardctx.current() is None


# ------------------------------------------------------------- elastic
def _outcome(fn, *a, **kw):
    try:
        return dataclasses.astuple(fn(*a, **kw))
    except ValueError as e:
        return ("raises", str(e))


def test_elastic_plans_match_reference():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 100, 128, 256, 384, 512):
        for tp in (1, 2, 4, 8, 16):
            for pods in (1, 2):
                for min_dp in (1, 4):
                    kw = dict(model_parallel=tp, pods=pods,
                              min_data_parallel=min_dp)
                    assert _outcome(elastic.plan_rescale, n, **kw) == _outcome(
                        ref_elastic.plan_rescale, n, **kw), (n, kw)
    for b in (1, 7, 16, 256):
        for hosts in (1, 3, 4, 8):
            assert elastic.rescale_batch_boundaries(b, hosts) == \
                ref_elastic.rescale_batch_boundaries(b, hosts)


# ------------------------------------------------------------ compress
def _quant_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1000,)).astype(np.float32) * 3
    x[256:512] = 0.0                                   # an all-zero block
    return {"vec": x,
            "mat": rng.normal(size=(7, 300)).astype(np.float32) / 100,
            "zeros": np.zeros((256,), np.float32),
            "ties": (np.arange(512, dtype=np.float32) - 256) / 2}


def test_quantize_int8_is_bit_equal_to_reference():
    for name, x in _quant_inputs().items():
        rq, rs = ref_compress.quantize_int8(jax.numpy.asarray(x))
        q, s = compress.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), err_msg=name)
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs), err_msg=name)
        rd = ref_compress.dequantize_int8(rq, rs, x.shape, jax.numpy.float32)
        d = compress.dequantize_int8(q, s, x.shape, torch.float32)
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd), err_msg=name)
    assert compress.wire_bytes(1000) == 4 * 256 + 4 * 4


# ------------------------------------------- reference, 8 virtual devices
REFERENCE_SNIPPET = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map as _shard_map
from repro.kernels import ops
from repro.optim.compress import compressed_psum

def shard_map(*a, **k):
    return jax.jit(_shard_map(*a, **k))

inp = {k: jnp.asarray(v) for k, v in np.load(%(inp)r).items()}
devs = np.array(jax.devices())
out = {}
row = P("d", None)
def body(xs, rs):
    s, nr = compressed_psum(xs[0], "d", residual=rs[0])
    return s[None], nr[None]
f = shard_map(body, mesh=Mesh(devs, ("d",)), in_specs=(row, row),
              out_specs=(row, row))
out["psum"], out["resid"] = f(inp["grads"], inp["resid"])
for d in %(dims)r:
    q, k, v, la = (inp[f"{n}{d}"] for n in ("q", "k", "v", "la"))
    for tag, mesh, names, sizes in (
            ("4", Mesh(devs[:4], ("data",)), ("data",), (4,)),
            ("24", Mesh(devs.reshape(2, 4), ("pod", "data")),
             ("pod", "data"), (2, 4))):
        sp = P(None, None, names)
        f = shard_map(lambda q, k, v, la: ops.ssd_scan(
            q, k, v, la, chunk=%(chunk)d, axis_names=names, axis_sizes=sizes),
            mesh=mesh, in_specs=(sp, sp, sp, sp), out_specs=sp)
        out[f"ssd{d}_{tag}"] = f(q, k, v, la)
np.savez(%(out)r, **{k: np.asarray(v) for k, v in out.items()})
mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
blocks = []
for shape, spec in %(placements)r:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    blocks.append([[[s.start or 0, n if s.stop is None else s.stop]
                    for s, n in zip(m[d], shape)] for d in mesh.devices.flat])
print("BLOCKS" + json.dumps(blocks))
"""
SSD_DIMS = (64, 256)
SSD_CHUNK = 32


def _multi_inputs():
    rng = np.random.default_rng(25)
    inp = {"grads": rng.normal(size=(8, 1000)).astype(np.float32),
           "resid": rng.normal(size=(8, 1000)).astype(np.float32) / 100}
    inp["grads"][:, 256:512] = 0.0
    inp["resid"][:, 256:512] = 0.0
    for d in SSD_DIMS:
        shape = (2, 2, 512, d)
        inp[f"q{d}"] = rng.normal(size=shape).astype(np.float32) / np.sqrt(d)
        inp[f"k{d}"] = rng.normal(size=shape).astype(np.float32) / np.sqrt(d)
        inp[f"v{d}"] = rng.normal(size=shape).astype(np.float32)
        inp[f"la{d}"] = -rng.uniform(0.0, 0.2, size=shape[:3]).astype(
            np.float32)
    return inp


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    d = tmp_path_factory.mktemp("multidevice")
    inp, out = str(d / "inp.npz"), str(d / "out.npz")
    data = _multi_inputs()
    np.savez(inp, **data)
    text = subproc(REFERENCE_SNIPPET % {
        "inp": inp, "out": out, "dims": SSD_DIMS, "chunk": SSD_CHUNK,
        "placements": PLACEMENTS}, devices=8)
    blocks = json.loads(text.split("BLOCKS", 1)[1].strip().splitlines()[0])
    return data, dict(np.load(out)), blocks


def test_compressed_psum_matches_reference_8_positions(reference):
    """8 CPU positions: the sums and the error-feedback residuals of the
    reference's shard_map on 8 devices; each residual is
    y - dequantize(quantize(y))."""
    data, ref, _ = reference
    mesh = spmd.Mesh(["cpu"] * 8, ("d",))
    row = spmd.P("d", None)

    def body(xs, rs):
        s, nr = compress.compressed_psum(xs[0], "d", residual=rs[0])
        return s[None], nr[None]

    x, r = torch.from_numpy(data["grads"]), torch.from_numpy(data["resid"])
    s, nr = spmd.shard_map(body, mesh, (row, row), (row, row))(x, r)
    np.testing.assert_allclose(s.numpy(), ref["psum"], rtol=PSUM_TOL,
                               atol=PSUM_TOL)
    # Under jit XLA divides by the block scales as a product with their
    # reciprocals: the residuals agree to float32 rounding, not bit for bit
    # as the eager quantize_int8 does.
    np.testing.assert_allclose(nr.numpy(), ref["resid"], rtol=PSUM_TOL,
                               atol=PSUM_TOL)
    y = x + r
    q, sc = compress.quantize_int8(y[3])
    want = y[3] - compress.dequantize_int8(q, sc, y[3].shape, torch.float32)
    np.testing.assert_array_equal(nr[3].numpy(), want.numpy())
    # Every position holds the same sum; the reference test's own bound.
    np.testing.assert_allclose(s[5].numpy(), y.sum(0).numpy(), rtol=0.05,
                               atol=0.05)
    assert torch.equal(s[0], s[7])


@pytest.mark.parametrize("d", SSD_DIMS)
def test_sequence_sharded_ssd_scan_matches_reference(reference, d):
    """L sharded over 4 positions and over a (2, 4) ("pod", "data") mesh:
    the reference's sharded scan on 8 devices and the port's unsharded
    scan, on the "xla" path and the kernels' plain versions."""
    data, ref, _ = reference
    q, k, v, la = (torch.from_numpy(data[f"{n}{d}"])
                   for n in ("q", "k", "v", "la"))
    whole = ops.ssd_scan(q, k, v, la, chunk=SSD_CHUNK)
    for tag, shape, names in (("4", (4,), ("data",)),
                              ("24", (2, 4), ("pod", "data"))):
        mesh = spmd.Mesh(["cpu"] * int(np.prod(shape)), names, shape)
        sp = spmd.P(None, None, names)
        for backend in ("xla", "pallas"):
            y = spmd.shard_map(
                lambda *a: ops.ssd_scan(*a, chunk=SSD_CHUNK, backend=backend,
                                        axis_names=names, axis_sizes=shape),
                mesh, sp, sp)(q, k, v, la)
            np.testing.assert_allclose(y.numpy(), ref[f"ssd{d}_{tag}"],
                                       rtol=SSD_TOL, atol=SSD_TOL,
                                       err_msg=f"{tag} {backend}")
            np.testing.assert_allclose(y.numpy(), whole.numpy(), rtol=SSD_TOL,
                                       atol=SSD_TOL, err_msg=f"{tag} {backend}")


# ---------------------------------------------- a (2, 2) gloo world
def _placement_rank(rank, device):
    from torch.distributed.tensor import Shard

    mesh = port_mesh.make_mesh((2, 2), ("data", "model"), device=device)
    out = {"shape": port_mesh.mesh_shape(mesh),
           "dp": port_mesh.dp_axes(mesh), "tp": port_mesh.tp_axis(mesh),
           "locals": []}
    for shape, spec in PLACEMENTS:
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32)
        t = shd.distribute({"x": full.reshape(shape)}, {"x": _spec(spec)},
                           mesh)["x"]
        out["locals"].append(t.to_local().numpy())
    # A shardctx anchor redistributes a DTensor to the reference's spec.
    x = shd.distribute(torch.ones(4, 6, 8), spmd.P(), mesh)
    with shardctx.activation_sharding(mesh, dp=("data",), tp="model"):
        y = shardctx.constrain_tokens_major(x)
        h = shardctx.constrain_heads(shd.distribute(torch.ones(4, 2, 6, 8),
                                                    spmd.P(), mesh))
    out["anchors"] = [list(y.placements) == [Shard(0), Shard(1)],
                      list(h.placements) == [Shard(0), Shard(1)],
                      torch.equal(y.full_tensor(), torch.ones(4, 6, 8))]
    out["moe"] = {e: _moe_on_mesh(mesh, e) for e in MOE_EXPERTS}
    return out


MOE_EXPERTS = (4, 3)    # "model" (2) divides 4: expert blocks; not 3


def _moe_on_mesh(mesh, n_experts):
    """The MoE layer (phi's smoke config with ``n_experts``) forward and
    backward on one device and on ``mesh`` (params by the rules, the batch
    over "data"): every output and gradient, one device's then the
    mesh's, as numpy."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.core._tree import tree_map
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              n_experts=n_experts)
    gen = torch.Generator().manual_seed(5)
    params = moe.moe_init(gen, cfg)
    x = torch.randn((4, 32, cfg.d_model), generator=gen)
    ct = torch.randn((4, 32, cfg.d_model), generator=gen)

    def run(p, x, ct):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        x = x.detach().requires_grad_()
        with shardctx.activation_sharding(mesh, dp=("data",), tp="model"), \
                implicit_replication():
            y, aux = moe.moe_apply(p, cfg, x)
            ((y * ct).sum() + 3.0 * aux).backward()
        leaves = [y, aux, x.grad] + [t.grad for t in tree_flatten(p)[0]]
        return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                .detach().numpy() for t in leaves]

    tree = {"moe": params}
    dist_p = shd.distribute(tree, shd.param_shardings(tree, cfg, mesh),
                            mesh)["moe"]
    rows = spmd.P("data")
    return run(params, x, ct), run(dist_p, shd.distribute(x, rows, mesh),
                                   shd.distribute(ct, rows, mesh))


@pytest.fixture(scope="module")
def gloo_world():
    """One (2, 2) gloo CPU world's results, every rank's."""
    return port_mesh.run_world(_placement_rank, 4, device="cpu")


def test_moe_layer_on_a_mesh_matches_one_device(gloo_world):
    """The MoE layer on a (2, 2) mesh, its experts kept in blocks over
    "model" (4 experts) or gathered whole (3), against one device: y, the
    aux loss and every gradient, float32, each within 1e-5 of its largest
    entry (the expert blocks' shares are summed in another order)."""
    for e in MOE_EXPERTS:
        one, mesh = gloo_world[0]["moe"][e]
        assert len(one) == len(mesh) == 7
        for a, b in zip(mesh, one):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * float(np.abs(b).max()),
                                       err_msg=f"{e} experts")


def test_dtensor_blocks_match_reference_devices_indices(reference,
                                                         gloo_world):
    """Each rank's local block of a laid-out tensor is the block the
    reference's NamedSharding gives the device at the same mesh position."""
    _, _, blocks = reference
    ranks = gloo_world
    for r, got in enumerate(ranks):
        assert got["shape"] == {"data": 2, "model": 2}
        assert got["dp"] == ("data",) and got["tp"] == "model"
        assert got["anchors"] == [True, True, True]
        for (shape, _), local, blk in zip(PLACEMENTS, got["locals"],
                                          blocks):
            full = np.arange(int(np.prod(shape)),
                             dtype=np.float32).reshape(shape)
            want = full[tuple(slice(a, b) for a, b in blk[r])]
            np.testing.assert_array_equal(local, want)
