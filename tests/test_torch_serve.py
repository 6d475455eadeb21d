"""The port's server against the reference's on Zamba2's smoke
config, and the counterparts of ``tests/test_system.py``'s serving tests.

Both servers get the same weights (``interop.params_from_numpy``) and the
same prompts, and must emit the same greedy token ids.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeConfig, Server

ARCH = "zamba2-7b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _requests(req_cls, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [req_cls(i, rng.integers(2, 500, n, dtype=np.int32), max_new=max_new)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("tb,rb", [("xla", "xla"),
                                   ("pallas", "pallas_interpret")])
def test_serve_batch_matches_reference_server(tb, rb):
    scfg = dict(arch=ARCH, smoke=True, eos_id=None, max_len=64)
    rsrv = ref_serve.Server(ref_serve.ServeConfig(**scfg))
    if rb != "xla":
        # The reference's Server has no way to pick a backend: swap its
        # config and steps after construction.
        rsrv.acfg = dataclasses.replace(rsrv.acfg, attn_backend=rb,
                                        ssm_backend=rb)
        rsrv._prefill = jax.jit(ref_steps.make_prefill_step(rsrv.acfg))
        rsrv._decode = jax.jit(ref_steps.make_decode_step(rsrv.acfg),
                               donate_argnums=(3,))
    acfg = dataclasses.replace(get_smoke_config(ARCH), attn_backend=tb,
                               ssm_backend=tb)
    tsrv = Server(ServeConfig(**scfg), params=params_from_numpy(
        jax.device_get(rsrv.params)), device="cpu", acfg=acfg)
    lens = [16, 11, 16]         # the short prompt is left-padded
    rreqs = _requests(ref_serve.Request, lens, max_new=8)
    treqs = _requests(Request, lens, max_new=8)
    rstats = rsrv.serve_batch(rreqs)
    tstats = tsrv.serve_batch(treqs)
    assert [r.output for r in treqs] == [r.output for r in rreqs]
    for key in ("batch", "decode_steps", "generated"):
        assert tstats[key] == rstats[key], key
    assert tstats["generated"] == 3 * 8
    assert not any(launch_counts().values())   # CPU: the plain versions


def test_server_defaults_and_acfg():
    """No ``acfg``: the registry's config (the reference's "xla" backends);
    a config passed in is used as given; ``device=None`` means CUDA."""
    srv = Server(ServeConfig(arch=ARCH), device="cpu")
    assert srv.acfg == get_smoke_config(ARCH)
    assert srv.acfg.attn_backend == srv.acfg.ssm_backend == "xla"
    assert srv.device == torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_backend="pallas",
                              ssm_backend="pallas")
    srv2 = Server(ServeConfig(arch=ARCH), params=srv.params, device="cpu",
                  acfg=cfg)
    assert srv2.acfg is cfg and srv2.params is srv.params


def test_server_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(ServeConfig(arch=ARCH))


def test_serve_batch_runs_full_length():
    """tests/test_system.py::test_serve_batch, on Zamba2's smoke config."""
    srv = Server(ServeConfig(arch=ARCH, smoke=True, eos_id=None), device="cpu")
    reqs = _requests(Request, [16, 16, 16], max_new=8)
    reset_launch_counts()
    stats = srv.serve_batch(reqs)
    assert stats["batch"] == 3
    assert stats["generated"] == 3 * 8
    assert all(r.done and len(r.output) == 8 for r in reqs)


def _stub_server(eos_id, script):
    """A Server with the model steps replaced by a scripted decoder.

    ``script[i]`` is the token sequence request ``i`` will greedily emit
    (prefill produces ``script[i][0]``, each decode step the next entry;
    the last entry repeats if the loop outruns the script).
    """
    vocab = 16
    b = len(script)

    def logits_for(step):
        out = torch.zeros((b, 1, vocab))
        for i, toks in enumerate(script):
            out[i, 0, toks[min(step, len(toks) - 1)]] = 1.0
        return out

    srv = Server.__new__(Server)
    srv.cfg_s = ServeConfig(eos_id=eos_id)
    srv.acfg = SimpleNamespace(frontend="token", frontend_len=0)
    srv.device = torch.device("cpu")
    srv.params = None
    srv._init_states = lambda b: (0, None)
    srv._prefill = lambda params, batch, states: (logits_for(0), states)
    calls = []

    def decode(params, tok, pos, states):
        calls.append(int(pos))
        return logits_for(len(calls)), states

    srv._decode = decode
    return srv, calls


def test_serve_eos_early_exit():
    """A request stops at its eos token and the step-locked loop exits as
    soon as every request is done — not at the global max_new."""
    eos = 7
    srv, calls = _stub_server(eos, [[3, eos, 5, 5, 5], [4, 5, 6, 5, 4]])
    reqs = [Request(0, np.array([2, 3], np.int32), max_new=10),
            Request(1, np.array([2, 3], np.int32), max_new=4)]
    stats = srv.serve_batch(reqs)
    assert reqs[0].output == [3, eos]          # truncated at eos, eos kept
    assert len(reqs[1].output) == 4            # its own max_new
    assert all(r.done for r in reqs)
    assert len(calls) == 3, calls
    assert calls == [8, 9, 10]                 # prompts left-padded to 8
    assert stats["decode_steps"] == 3
    assert stats["generated"] == 2 + 4
    assert stats["tokens_per_s"] >= 0.0


def test_serve_all_eos_skips_decode():
    """Every request hitting eos at prefill means zero decode steps."""
    eos = 7
    srv, calls = _stub_server(eos, [[eos, 1, 1], [eos, 2, 2]])
    reqs = [Request(0, np.array([2], np.int32), max_new=8),
            Request(1, np.array([2], np.int32), max_new=8)]
    srv.serve_batch(reqs)
    assert calls == []
    assert reqs[0].output == [eos] and reqs[1].output == [eos]


def test_serve_eos_disabled_runs_to_max_new():
    srv, calls = _stub_server(None, [[7, 7, 7], [7, 7, 7]])
    reqs = [Request(0, np.array([2], np.int32), max_new=5),
            Request(1, np.array([2], np.int32), max_new=5)]
    stats = srv.serve_batch(reqs)
    assert len(calls) == 4                     # max_new - 1, no early exit
    assert all(len(r.output) == 5 for r in reqs)
    assert stats["generated"] == 10


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "16",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] batch=2" in out


def test_prompt_length_must_divide_into_blocks():
    """As in the reference, a prompt of 384 tokens fails the kernel
    backend's block checks (flash attention's 256-row query block does not
    divide it) and is not padded; 512 passes."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_backend="pallas",
                              ssm_backend="pallas")
    srv = Server(ServeConfig(arch=ARCH, eos_id=None, max_len=520),
                 device="cpu", acfg=cfg)
    with pytest.raises(AssertionError):
        srv.serve_batch(_requests(Request, [384], max_new=2))
    x = jax.numpy.zeros((1, 384, 16))
    with pytest.raises(AssertionError):
        ref_flash(x, x, x, interpret=True)
    stats = srv.serve_batch(_requests(Request, [512], max_new=2))
    assert stats["generated"] == 2
