"""Multilevel rigid image registration (paper §2.3, Berkels et al. [6]).

PyTorch port of ``repro/core/registration.py``.

Function **A**: register template to reference by minimizing 1 - NCC with a
multilevel (image pyramid) scheme and gradient descent whose iteration count
is *data-dependent* (a convergence criterion) — the source of the
unpredictable operator cost that motivates the paper.  The reference's
vmapped ``lax.while_loop`` is a Python loop over a batch axis here; its
``jax.grad`` is ``torch.autograd.grad`` of the summed per-lane losses (the
lanes are independent, so each lane receives exactly its own gradient).

Function **B** (the scan operator, §2.3.2): given phi_{i,j} and phi_{j,k},
start from the composition phi_{j,k} o phi_{i,j} and refine with A on the
frame pair (f_i, f_k).

The scan element is ``RegElement = (deformation, i, k)``: 3 floats + 2 ints,
the paper's 20-byte payload.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.runtime.tracing import span

from ._tree import tree_index
from .deformation import (
    Deformation,
    compose,
    downsample2,
    identity_deformation,
    ncc_distance,
)


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    # Pyramid depth is kept shallow: downsampling shrinks the lattice period
    # and with it the attraction basin (period/2, §2.3.2) — 2 levels preserves
    # the basin while still accelerating convergence.
    levels: int = 2              # pyramid depth
    max_iters: int = 300         # per level
    lr_shift: float = 1.0        # gradient step for translation (pixels)
    lr_angle: float = 5e-4       # gradient step for rotation (radians)
    tol: float = 1e-7            # stop when |Delta D| < tol
    estimate_rotation: bool = True


class RegResult(NamedTuple):
    deformation: Deformation
    distance: torch.Tensor       # final 1 - NCC
    iterations: torch.Tensor     # total gradient iterations (cost proxy)
    steps: int = 0               # batched gradient steps run, over all levels
                                 # (the host's count: the slowest lane's)
    kernel_steps: int = 0        # those of them the ncc_grad kernels ran


def _minimize_level(
    ref: torch.Tensor,
    tmpl: torch.Tensor,
    init: Deformation,
    cfg: RegistrationConfig,
) -> Tuple[Deformation, torch.Tensor, torch.Tensor, int, int]:
    """Gradient flow on one pyramid level with data-dependent stopping,
    over a batch of pairs: ``ref``/``tmpl`` ``(B, h, w)``, ``init`` with
    ``angle (B,)`` and ``shift (B, 2)``.  Returns the deformations, the
    final distances, each lane's iterations, the batched steps run and
    those of them the kernels ran.

    The loop is *per-lane frozen*: it runs while any lane is active, and
    ``active`` masks every update, so each lane follows exactly its solo
    trajectory and counts its own iterations whatever batch it runs in.
    The batch pays for every step its slowest lane takes: ``steps`` times
    ``B`` lane-steps, of which the lanes' iterations are the useful ones.

    The route follows where the frames lie, as ``fused_ncc_distance``'s
    does: on a CUDA device the ``ncc_grad`` kernels (the loss and its
    analytic gradient from one pass, the masked update on the card), on
    the CPU the plain autograd version.
    """
    if ref.device.type == "cuda":
        return _minimize_level_kernel(ref, tmpl, init, cfg)
    return _minimize_level_plain(ref, tmpl, init, cfg)


def _minimize_level_plain(
    ref: torch.Tensor,
    tmpl: torch.Tensor,
    init: Deformation,
    cfg: RegistrationConfig,
) -> Tuple[Deformation, torch.Tensor, torch.Tensor, int, int]:
    """:func:`_minimize_level` through ``torch.autograd``, on any device.

    Each step's loss at the new point is computed with its graph kept, and
    the next step differentiates that graph, where the reference evaluates
    the same loss twice (once under ``grad``, once for the stopping test).
    """
    ang_step = cfg.lr_angle if cfg.estimate_rotation else 0.0

    def loss_with_graph(d):
        leaves = {k: v.detach().requires_grad_(True) for k, v in d.items()}
        return leaves, ncc_distance(ref, tmpl, leaves)

    d = {k: v.detach() for k, v in init.items()}
    with torch.enable_grad():
        # (leaves, loss) of the point the next gradient is taken at.  Lanes
        # that may still step are exactly the lanes active in the previous
        # step (a frozen lane never thaws), and their point is the one whose
        # loss was computed last — so that graph serves every lane that
        # matters, and frozen lanes' gradients are masked out.
        leaves, loss_g = loss_with_graph(d)
        cur = loss_g.detach()
        prev = cur + 1.0
        it = torch.zeros(cur.shape, dtype=torch.int32, device=cur.device)
        steps = 0
        act = (it < cfg.max_iters) & ((prev - cur).abs() > cfg.tol)
        more = bool(act.any())
        while more:
            with span("repro.fnA.step"):
                g_angle, g_shift = torch.autograd.grad(
                    loss_g.sum(), [leaves["angle"], leaves["shift"]]
                )
                d_new = {
                    "angle": d["angle"] - ang_step * g_angle,
                    "shift": d["shift"] - cfg.lr_shift * g_shift,
                }
                leaves, loss_g = loss_with_graph(d_new)
                new = loss_g.detach()
                d = {
                    "angle": torch.where(act, d_new["angle"], d["angle"]),
                    "shift": torch.where(act[:, None], d_new["shift"],
                                         d["shift"]),
                }
                prev = torch.where(act, cur, prev)
                cur = torch.where(act, new, cur)
                it = it + act.to(torch.int32)
                act = (it < cfg.max_iters) & ((prev - cur).abs() > cfg.tol)
                more = bool(act.any())
            steps += 1
    return d, cur, it, steps, 0


def _minimize_level_kernel(
    ref: torch.Tensor,
    tmpl: torch.Tensor,
    init: Deformation,
    cfg: RegistrationConfig,
) -> Tuple[Deformation, torch.Tensor, torch.Tensor, int, int]:
    """:func:`_minimize_level` through the ``ncc_grad`` kernels: one sums
    pass and fold at ``init``, then one of each a step; the same update,
    freezing and stopping rule as the plain version, in float32, with the
    loss and its gradient folded from float64 sums."""
    from repro_torch.kernels.ncc_grad import Descent

    desc = Descent(
        ref.contiguous(), tmpl.contiguous(), init["angle"], init["shift"],
        lr_angle=cfg.lr_angle if cfg.estimate_rotation else 0.0,
        lr_shift=cfg.lr_shift, tol=cfg.tol, max_iters=cfg.max_iters,
    )
    more = desc.start()
    steps = 0
    while more:
        with span("repro.fnA.step"):
            more = desc.step()
        steps += 1
    return desc.deformation, desc.cur, desc.it, steps, steps


def _pyramid(img: torch.Tensor, levels: int):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr[::-1]  # coarse -> fine


def register_pair(
    ref: torch.Tensor,
    tmpl: torch.Tensor,
    init: Optional[Deformation] = None,
    cfg: RegistrationConfig = RegistrationConfig(),
) -> RegResult:
    """Function A: estimate phi with f_tmpl o phi ~= f_ref (multilevel).

    ``ref``/``tmpl`` are one pair ``(H, W)`` or a batch ``(B, H, W)``
    (``init`` then batched alike, or None for the identity)."""
    single = ref.dim() == 2
    if single:
        ref, tmpl = ref[None], tmpl[None]
        if init is not None:
            init = {k: v[None] for k, v in init.items()}
    b = ref.shape[0]
    if init is None:
        ident = identity_deformation(device=ref.device)
        init = {k: v.expand((b,) + v.shape).clone() for k, v in ident.items()}
    refs = _pyramid(ref, cfg.levels)
    tmps = _pyramid(tmpl, cfg.levels)
    scale = 2.0 ** (cfg.levels - 1)
    d = {"angle": init["angle"], "shift": init["shift"] / scale}
    total_iters = torch.zeros((b,), dtype=torch.int32, device=ref.device)
    total_steps = kernel_steps = 0
    dist = torch.zeros((b,), device=ref.device)
    for lvl, (r, t) in enumerate(zip(refs, tmps)):
        d, dist, iters, steps, k_steps = _minimize_level(r, t, d, cfg)
        total_iters = total_iters + iters
        total_steps += steps
        kernel_steps += k_steps
        if lvl != len(refs) - 1:
            d = {"angle": d["angle"], "shift": d["shift"] * 2.0}
    if single:
        return RegResult(tree_index(d, 0), dist[0], total_iters[0],
                         total_steps, kernel_steps)
    return RegResult(d, dist, total_iters, total_steps, kernel_steps)


# ---------------------------------------------------------------------------
# Series registration as a prefix scan
# ---------------------------------------------------------------------------


class RegElement(NamedTuple):
    """Scan element phi_{i,k}: 'f_k o phi ~= f_i' plus the index pair."""

    deformation: Deformation
    i: int
    k: int


class SeriesRegistrar:
    """Owns the frame series and exposes the scan operator (.)_B.

    ``refine=True`` is the paper's operator B (compose + re-register, data-
    dependent cost); ``refine=False`` degrades to pure composition (exactly
    associative, cheap — useful as an oracle and for vectorized execution).
    """

    def __init__(
        self,
        frames,                       # (N, H, W) tensor or a frame store
        cfg: RegistrationConfig = RegistrationConfig(),
        refine: bool = True,
    ):
        self.frames = frames
        self.cfg = cfg
        self.refine = refine

    # -- preprocessing: function A on consecutive pairs (massively parallel).
    def preprocess(self) -> list:
        n = self.frames.shape[0]
        elems = []
        for i in range(n - 1):
            res = register_pair(
                self.frames[i], self.frames[i + 1], None, self.cfg
            )
            elems.append(RegElement(res.deformation, i, i + 1))
        return elems

    def preprocess_vmapped(self) -> list:
        """Batched function-A over all consecutive pairs (one batched call)."""
        res = register_pair(self.frames[:-1], self.frames[1:], None, self.cfg)
        n = self.frames.shape[0]
        return [
            RegElement(tree_index(res.deformation, i), i, i + 1)
            for i in range(n - 1)
        ]

    # -- the scan operator (.)_B  (paper §3).
    def op(self, a: RegElement, b: RegElement) -> RegElement:
        if a.k != b.i:
            raise ValueError(f"non-adjacent elements {a.i, a.k} . {b.i, b.k}")
        guess = compose(a.deformation, b.deformation)
        if not self.refine:
            return RegElement(guess, a.i, b.k)
        res = register_pair(
            self.frames[a.i], self.frames[b.k], guess, self.cfg
        )
        return RegElement(res.deformation, a.i, b.k)

    # -- plain sequential series registration (the paper's baseline).
    def sequential(self, elems=None) -> list:
        elems = self.preprocess() if elems is None else elems
        out = [elems[0]]
        for e in elems[1:]:
            out.append(self.op(out[-1], e))
        return out


# ---------------------------------------------------------------------------
# Engine adapter: Function B as a telemetered scan operator
# ---------------------------------------------------------------------------


def fused_ncc_distance(
    ref: torch.Tensor,
    tmpl: torch.Tensor,
    d: Deformation,
    *,
    tile: int = 32,
) -> torch.Tensor:
    """1 - NCC(ref, tmpl o d) through the fused warp+NCC kernel.

    One pass over output tiles computes the warp and the five NCC partial
    sums (``kernels/warp_ncc.py``): for tensors on the card the CUDA kernel,
    then its fold into the distance on the card (two launches, reading the
    angle and shift tensors of ``d`` as they are); for tensors on the CPU
    the plain PyTorch version.  Equivalent to
    :func:`~repro_torch.core.deformation.ncc_distance` up to fp
    accumulation order.
    """
    from repro_torch.kernels.warp_ncc import ncc_distance

    return ncc_distance(tmpl, ref, d["angle"], d["shift"], tile=tile)


def fused_ncc_eligible(shape: Tuple[int, int], tile: int = 32) -> bool:
    """The warp_ncc kernel tiles the output: both dims must divide by tile."""
    h, w = shape
    return h % tile == 0 and w % tile == 0


def fused_default(
    device, shape: Tuple[int, int], tile: int = 32,
    fused: Optional[bool] = None,
) -> bool:
    """Whether the guess check goes through ``warp_ncc``: on a CUDA device by
    default (the reference: on a TPU), and only for tile-divisible frames."""
    if fused is None:
        fused = device is not None and torch.device(device).type == "cuda"
    return bool(fused) and fused_ncc_eligible(shape, tile)


class RegistrationOperator:
    """Engine-facing adapter around Function B (the scan operator ``(.)_B``).

    Lets ``repro_torch.core.engine.scan`` treat series registration as any
    other element-domain scan while closing two loops the raw method can't:

    * **cost telemetry** — every application's wall time is recorded into an
      :class:`~repro_torch.core.engine.telemetry.OpTelemetry`; the adapter
      exposes ``op_cost_estimate`` so the dispatcher routes the *next* call
      from observed costs (data-dependent iteration counts drift over a
      series).
    * **fused guess check** — when ``skip_tol`` is set, the composed initial
      guess phi_{j,k} o phi_{i,j} is scored first and refinement is skipped
      when it already registers within tolerance.  The warp+NCC evaluation
      routes through the fused kernel (``kernels/warp_ncc.py``) where
      eligible (tile-divisible frames; on a CUDA device by default,
      ``fused=True`` forces the plain version of the kernel on the CPU).

    Thread-safe — the work-stealing executors apply it concurrently.
    """

    # Process-wide record of which (frame shape, config, code path)
    # signatures have already run once.  The first application under a
    # fresh signature pays one-off costs (CUDA context and library set-up,
    # the kernel's first load); classifying it
    # (``telemetry.record(..., compile=True)``) keeps them out of the cost
    # EMA the dispatcher plans the whole series around.
    _warm_signatures: set = set()
    _warm_lock = threading.Lock()

    @classmethod
    def _reset_compile_tracking(cls) -> None:
        """Forget warm signatures (tests)."""
        with cls._warm_lock:
            cls._warm_signatures.clear()

    def __init__(
        self,
        registrar: SeriesRegistrar,
        *,
        name: str = "registration_B",
        telemetry=None,
        skip_tol: Optional[float] = None,
        fused: Optional[bool] = None,
        tile: int = 32,
    ):
        from .engine.telemetry import OpTelemetry

        self.registrar = registrar
        self.telemetry = (
            telemetry if telemetry is not None else OpTelemetry(name=name)
        )
        self.skip_tol = skip_tol
        self.tile = tile
        h, w = registrar.frames.shape[1:]
        self.fused = fused_default(
            getattr(registrar.frames, "device", None), (h, w), tile, fused
        )
        # This adapter's applications (a session makes one a feed):
        # guess checks that skipped or refined, and the refinements'
        # gradient steps (one lane: steps are iterations), those of them
        # the ncc_grad kernels ran, and thread-seconds.
        self.skipped = 0
        self.refined = 0
        self.refine_iters = 0
        self.refine_kernel_steps = 0
        self.refine_s = 0.0
        # What ``engine.scan(stats=...)`` measured of the scans run with
        # this adapter (``StealStats``/``HierStats``).
        self.scan_stats: list = []
        self._op_base = self._op_total()
        self._count_lock = threading.Lock()
        self._elem_prior: Optional[list] = None
        self._elem_obs: dict = {}

    # -- the dispatcher feedback hook (read by engine.scan via telemetry).
    @property
    def op_cost_estimate(self) -> Optional[float]:
        return self.telemetry.estimate()

    @property
    def op_imbalance_estimate(self) -> Optional[float]:
        """Observed max/mean per-call cost ratio; None until at least two
        samples exist — a single one (e.g. the ``prime()`` seed) always
        reads 1.0 and would wrongly disable cross-segment stealing."""
        return self.telemetry.imbalance() if self.telemetry.calls >= 2 else None

    def prime(self, seconds_per_call: float) -> None:
        """Seed the cost estimate before the first application (e.g. from
        the function-A preprocessing stage, whose per-pair cost is the same
        minimiser on the same frames)."""
        self.telemetry.record(seconds_per_call)
        self._op_base = self._op_total()

    def _op_total(self) -> float:
        return self.telemetry.total_time + self.telemetry.compile_time

    @property
    def op_s(self) -> float:
        """Thread-seconds of this adapter's applications, read from its
        telemetry (which no other adapter may record into meanwhile)."""
        return self._op_total() - self._op_base

    def prime_elements(self, costs) -> None:
        """Seed *per-element* relative cost priors (any unit — e.g. the
        function-A per-pair iteration counts, the paper's cost proxy).
        Consumed by the hierarchical backend's ahead-of-time segment
        sizing: segments start equal-*cost*, not equal-count."""
        with self._count_lock:
            self._elem_prior = [float(c) for c in costs]

    def element_cost_estimates(self, n: int) -> Optional[list]:
        """Relative per-element cost vector combining the prior with
        observed per-application wall times, or None when neither exists
        at this length.  Observations are rescaled by aligning the two
        means *over the observed indices*, so observing only the stragglers
        does not erase the imbalance signal."""
        with self._count_lock:
            prior = self._elem_prior
            obs = dict(self._elem_obs)
        obs = {j: v for j, v in obs.items() if 0 <= j < n and v > 0}
        have_prior = prior is not None and len(prior) == n
        if have_prior:
            m = sum(prior) / n
            out = [p / m if m > 0 else 1.0 for p in prior]
        elif len(obs) == n:
            out = [1.0] * n  # full coverage: pure rescale below
        else:
            # No prior and only partial observations: no basis to rank
            # unobserved elements against observed ones.
            return None
        if obs:
            obs_mean = sum(obs.values()) / len(obs)
            prior_mean_at_obs = sum(out[j] for j in obs) / len(obs)
            scale = prior_mean_at_obs / obs_mean if obs_mean > 0 else 0.0
            if scale > 0:
                for j, v in obs.items():
                    out[j] = v * scale
        return out

    def _guess_distance(self, ref, tmpl, guess):
        if self.fused:
            return fused_ncc_distance(ref, tmpl, guess, tile=self.tile)
        return ncc_distance(ref, tmpl, guess)

    def __call__(self, a: RegElement, b: RegElement) -> RegElement:
        t0 = time.perf_counter()
        reg = self.registrar
        sig = (
            tuple(reg.frames.shape[1:]), reg.cfg, reg.refine,
            self.skip_tol is not None, self.fused,
        )
        # Cold until the first call under this signature *completes*.
        with RegistrationOperator._warm_lock:
            cold = sig not in RegistrationOperator._warm_signatures
        # Attribute the cost to whichever operands ARE single scan elements
        # (left folds pass the fresh element as ``a``, right folds as ``b``);
        # partial∘partial combines have no single element and are skipped.
        elem_idxs = [e.k - 1 for e in (a, b) if e.k - e.i == 1]
        try:
            if a.k != b.i:
                raise ValueError(
                    f"non-adjacent elements {a.i, a.k} . {b.i, b.k}"
                )
            with span("repro.op.check"):
                guess = compose(a.deformation, b.deformation)
                if not reg.refine:
                    return RegElement(guess, a.i, b.k)
                if self.skip_tol is not None:
                    dist = self._guess_distance(
                        reg.frames[a.i], reg.frames[b.k], guess
                    )
                    if float(dist) < self.skip_tol:
                        with self._count_lock:
                            self.skipped += 1
                        return RegElement(guess, a.i, b.k)
            t_refine = time.perf_counter()
            with span("repro.op.refine"):
                res = register_pair(reg.frames[a.i], reg.frames[b.k], guess,
                                    reg.cfg)
            with self._count_lock:
                self.refined += 1
                self.refine_iters += res.steps
                self.refine_kernel_steps += res.kernel_steps
                self.refine_s += time.perf_counter() - t_refine
            return RegElement(res.deformation, a.i, b.k)
        finally:
            dt = time.perf_counter() - t0
            self.telemetry.record(dt, compile=cold)
            with RegistrationOperator._warm_lock:
                RegistrationOperator._warm_signatures.add(sig)
            if elem_idxs and not cold:
                with self._count_lock:
                    for j in elem_idxs:
                        prev = self._elem_obs.get(j)
                        self._elem_obs[j] = (
                            dt if prev is None else 0.5 * prev + 0.5 * dt
                        )
