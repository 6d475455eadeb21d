"""Batched server: prefill + step-locked decode with request
batching (port of ``repro/launch/serve.py``).

Requests arrive with prompts, are batched up to ``max_batch``, left-padded
and prefilled in one pass, then decoded step-locked (all sequences advance
together; finished sequences stop collecting output).  Greedy sampling.

``Server`` takes one keyword the reference's lacks, ``acfg``: an
:class:`ArchConfig` to serve with instead of ``get_config(arch)``.  The
registry's configs keep the reference's ``attn_backend="xla"`` and
``ssm_backend="xla"``, so the kernels run only when a caller passes a config
with ``"pallas"`` backends, e.g.
``acfg=dataclasses.replace(get_config("qwen3-32b"), attn_backend="pallas",
ssm_backend="pallas")``.

Usage:
  python -m repro_torch.launch.serve --arch xlstm-350m --smoke --requests 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

from . import steps


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (Lp,) int32
    max_new: int = 16
    done: bool = False
    output: Optional[List[int]] = None


@dataclasses.dataclass
class ServeConfig:
    arch: str = "xlstm-350m"
    smoke: bool = True
    max_batch: int = 4
    max_len: int = 512
    # End-of-sequence token: a request stops as soon as it emits this id
    # (the eos is kept as the last output token), and the step-locked decode
    # loop exits early once every request in the batch is finished.  None
    # disables eos detection (all requests run to their max_new).
    eos_id: Optional[int] = 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    def __init__(self, cfg_s: ServeConfig, params=None, *,
                 device: DeviceLike = None,
                 acfg: Optional[ArchConfig] = None):
        self.cfg_s = cfg_s
        self.device = resolve_device(device)
        if acfg is None:
            acfg = (get_smoke_config if cfg_s.smoke else get_config)(cfg_s.arch)
        self.acfg = acfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = lm.init_params(gen, self.acfg)
        self.params = params
        self._prefill = steps.make_prefill_step(self.acfg)
        self._decode = steps.make_decode_step(self.acfg)

    def _extras(self, b: int):
        """The frontend stubs' inputs for a batch of ``b``: zero patch or
        frame embeddings at (b, frontend_len, d_model) in the compute dtype,
        as the reference's server feeds them."""
        cfg = self.acfg
        key = {"patch": "patches", "audio": "frames"}.get(cfg.frontend)
        if key is None:
            return {}
        return {key: torch.zeros((b, cfg.frontend_len, cfg.d_model),
                                 dtype=cfg.cdtype, device=self.device)}

    def _init_states(self, b: int):
        """Fresh decode states for a batch of ``b``; returns (prefix, states).

        ``prefix`` is the number of frontend positions prepended before the
        prompt tokens (patch frontends decode after their patch block), and
        the caches hold ``prefix + max_len`` positions.  Split out of
        :meth:`serve_batch` so tests can stub the model steps without
        touching state allocation.
        """
        cfg = self.acfg
        prefix = cfg.frontend_len if cfg.frontend == "patch" else 0
        return prefix, lm.init_decode_states(
            cfg, b, prefix + self.cfg_s.max_len, device=self.device)

    def serve_batch(self, requests: List[Request]) -> Dict[str, Any]:
        """Prefill + decode one batch of requests; returns timing stats.

        Step-locked greedy decode: all sequences advance together, but each
        request stops accumulating output once it emits ``cfg_s.eos_id``
        (kept as its final token) or reaches its own ``max_new``, and the
        whole loop exits as soon as every request is finished.
        ``tokens_per_s`` counts tokens actually delivered, not batch slots.
        Blocking; timings are wall-clock seconds, each phase ending in a
        device synchronisation.
        """
        cfg_s = self.cfg_s
        b = len(requests)
        lp = max(len(r.prompt) for r in requests)
        lp = max(lp, 8)
        prompts = np.zeros((b, lp), np.int32)
        for i, r in enumerate(requests):
            prompts[i, -len(r.prompt):] = r.prompt  # left-pad
        prefix, states = self._init_states(b)
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                           device=self.device),
                 **self._extras(b)}
        _sync(self.device)
        t0 = time.time()
        logits, states = self._prefill(self.params, batch, states)
        _sync(self.device)
        t_prefill = time.time() - t0
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        tok_host = tok.cpu().numpy()
        outs = [[int(tok_host[i, 0])] for i in range(b)]
        eos = cfg_s.eos_id

        def finished(i: int) -> bool:
            o = outs[i]
            return len(o) >= requests[i].max_new or (
                eos is not None and o[-1] == eos
            )

        max_new = max(r.max_new for r in requests)
        t0 = time.time()
        pos = prefix + lp
        steps_run = 0
        for step in range(max_new - 1):
            if all(finished(i) for i in range(b)):
                break  # every request hit eos or its own max_new
            logits, states = self._decode(self.params, tok, pos + step, states)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            steps_run += 1
            tok_host = tok.cpu().numpy()
            for i in range(b):
                if not finished(i):
                    outs[i].append(int(tok_host[i, 0]))
        _sync(self.device)
        t_decode = time.time() - t0
        for r, o in zip(requests, outs):
            r.output = o
            r.done = True
        generated = sum(len(o) for o in outs)
        return {
            "batch": b,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_steps": steps_run,
            "generated": generated,
            "tokens_per_s": generated / t_decode if t_decode > 0 else 0.0,
        }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    srv = Server(ServeConfig(arch=args.arch, smoke=args.smoke,
                             max_batch=args.requests),
                 device=args.device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(i, rng.integers(2, srv.acfg.vocab_size, args.prompt_len,
                                dtype=np.int32), max_new=args.max_new)
        for i in range(args.requests)
    ]
    stats = srv.serve_batch(reqs)
    print(f"[serve] batch={stats['batch']} prefill={stats['prefill_s']*1e3:.0f}ms "
          f"decode={stats['decode_s']*1e3:.0f}ms "
          f"throughput={stats['tokens_per_s']:.1f} tok/s")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.output[:8]}...")


if __name__ == "__main__":
    main()
