"""The JAX package's key schedules, which the port's trainers draw from.

A port run from seed ``s`` draws what the JAX run from seed ``s`` draws:
the same initial weights (``models/jax_init.py``) and, here, the same
shuffles, dropout masks and opt-in draws (``ops/prng.py``).  The JAX package
has one key schedule a trainer:

- **"loop"**, its epoch loop (``mmer_tpu/train/loop.py:163-175``, ``:204``,
  ``train_model(fused=False)``): ``rng, init_key = split(PRNGKey(s))``; an
  epoch takes ``rng, shuffle_key = split(rng)`` and
  ``permutation(shuffle_key, n)``, and a step's dropout key is
  ``fold_in(rng, step)`` with ``step`` the run's global step count;
- **"fused"**, its whole-run trainer and seed batches
  (``mmer_tpu/train/fused.py:114-154``, ``train_model(fused=True)``,
  ``train_many_seeds``): an epoch takes ``rng, shuffle_key, epoch_key =
  split(rng, 3)``, and a step's dropout key is ``fold_in(epoch_key, i)`` with
  ``i`` the step within the epoch; modality dropout's ``u`` is
  ``uniform(fold_in(key, 103), (B,))``, mixup's ``λ`` is ``beta(fold_in(key,
  101), α, α)`` and its partners ``permutation(fold_in(key, 102), B)``;
- **"streaming"** (``mmer_tpu/train/streaming.py:39-52``): the dropout key of
  the global step is ``fold_in(PRNGKey(s), step)``; the dataset shuffles
  itself.

Each flax ``Dropout`` site draws ``bernoulli(make_rng("dropout"), keep,
shape)``, its key the step's key folded with the site's path and counter
(``models/fusion.py:dropout_draws``).  A step's masks, ``u`` and the sort keys
of ``j`` come from one :class:`~mmer_tpu_torch.ops.prng.DrawPlan` launch (one
lane a seed for seed batches); ``j`` is then one stable sort a round.  The
epoch's permutation is one more launch and sort a round, and its ``λ`` are
drawn on the host before the epoch starts (``prng.beta_many``).
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig, TrainConfig
from mmer_tpu_torch.models.fusion import dropout_draws, dropout_scales
from mmer_tpu_torch.ops import prng

SCHEDULES = ("loop", "fused", "streaming")


class StepRandom(NamedTuple):
    """A step's draws: the dropout masks at the global batch's full width in
    the order the forward applies them, the sites' scales
    (``models/fusion.py:dropout_scales``), and the opt-ins' ``u`` and ``j``
    (None when off).  Seed batches put a lane axis first."""
    masks: List[torch.Tensor]
    scales: list
    u: Optional[torch.Tensor] = None
    j: Optional[torch.Tensor] = None


class KeySchedule:
    """The random stream of a run (``schedule`` one of :data:`SCHEDULES`)
    for ``seeds``, with global batch ``batch`` of ``t`` video tokens, drawn
    on ``device``.  ``lanes``: the seeds are the lanes of one batched
    program (outputs get a leading seed axis); else ``seeds`` holds one
    seed."""

    def __init__(self, seeds: Sequence[int], schedule: str,
                 model_cfg: ModelConfig, train_cfg: TrainConfig, batch: int,
                 t: int, device: torch.device | str, *, lanes: bool = False):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown key schedule {schedule!r}")
        seeds = [int(s) for s in seeds]
        if not lanes and len(seeds) != 1:
            raise ValueError("one seed, or lanes=True")
        self.schedule, self.device = schedule, torch.device(device)
        self.lanes = len(seeds) if lanes else None
        self.rngs: List[prng.Key] = [
            prng.PRNGKey(s) if schedule == "streaming"
            else prng.split(prng.PRNGKey(s))[0] for s in seeds]
        self.step = 0                  # the global step ("loop", "streaming")
        self._base: List[prng.Key] = list(self.rngs)
        self._i = 0                    # the step within the epoch ("fused")
        fused = schedule == "fused"
        self.alpha = train_cfg.mixup_alpha if fused else 0.0
        draws = dropout_draws(model_cfg, batch, t)
        self.n_masks = len(draws)
        self.scales = dropout_scales(model_cfg, self.device)
        self.md = fused and train_cfg.modality_dropout > 0.0
        if self.md:
            draws.append(prng.Draw((103,), (batch,), "uniform"))
        self.j_rounds = 0
        if self.alpha > 0.0:
            j_draws = prng.permutation_draws((102,), batch)
            draws += j_draws
            self.j_rounds = len(j_draws)
        self.plan = (prng.DrawPlan(draws, self.device, lanes=self.lanes)
                     if draws else None)
        self.lambda_ms: List[float] = []   # host ms of each epoch's λ draws

    def begin_epoch(self, n: int, steps: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Advance the keys to a new epoch of ``steps`` steps over ``n``
        training rows: → (the epoch's permutation of ``range(n)`` on the
        device, the epoch's mixup weights, float32 ``(steps,)``, or None).
        Seed batches get ``(S, n)`` and ``(S, steps)``."""
        if self.schedule == "streaming":
            raise ValueError("the streaming schedule has no epochs: its "
                             "dataset shuffles itself")
        shuffle = [prng.fold_in(r, 1) for r in self.rngs]
        if self.schedule == "fused":
            self._base = [prng.fold_in(r, 2) for r in self.rngs]
            self._i = 0
        self.rngs = [prng.fold_in(r, 0) for r in self.rngs]
        if self.schedule == "loop":
            self._base = list(self.rngs)
        perm_draws = prng.permutation_draws((), n)
        if perm_draws:
            sort_keys = prng.DrawPlan(perm_draws, self.device,
                                      lanes=self.lanes).draw(shuffle)
            perm = prng.permute_by_keys(sort_keys)
        else:
            perm = torch.zeros(((self.lanes,) if self.lanes else ()) + (n,),
                               dtype=torch.int64, device=self.device)
        lams = None
        if self.alpha > 0.0:
            t0 = time.perf_counter()
            k0 = torch.tensor([b[0] for b in self._base], dtype=torch.int64)
            k1 = torch.tensor([b[1] for b in self._base], dtype=torch.int64)
            i = torch.arange(steps, dtype=torch.int64)
            keys = prng.fold_in_many(
                (k0.repeat_interleave(steps), k1.repeat_interleave(steps)),
                i.repeat(len(self._base)))
            keys = prng.fold_in_many(keys, 101)
            lam = prng.beta_many(keys, self.alpha, self.alpha).reshape(
                len(self._base), steps)
            lams = torch.from_numpy(lam if self.lanes else lam[0]).to(self.device)
            self.lambda_ms.append((time.perf_counter() - t0) * 1e3)
        return perm, lams

    def draw(self) -> StepRandom:
        """The next step's draws (one kernel launch on the card)."""
        if self.schedule == "fused":
            step, self._i = self._i, self._i + 1
        else:
            step, self.step = self.step, self.step + 1
        outs = [] if self.plan is None else self.plan.draw(self._base, step)
        masks = outs[:self.n_masks]
        u = outs[self.n_masks] if self.md else None
        j = (prng.permute_by_keys(outs[len(outs) - self.j_rounds:])
             if self.j_rounds else None)
        return StepRandom(masks, self.scales, u, j)

    def state(self) -> dict:
        """JAX's ``TrainState.rng`` (two uint32 words a lane) and ``step``:
        what a mid-run checkpoint keeps."""
        return {"rng": torch.tensor(np.asarray(self.rngs, np.uint32).astype(np.int64)),
                "step": self.step}

    def load(self, state: dict) -> None:
        rng = [tuple(int(w) for w in row) for row in state["rng"].tolist()]
        if len(rng) != len(self.rngs):
            raise ValueError(f"a checkpoint of {len(rng)} keys for "
                             f"{len(self.rngs)} lanes")
        self.rngs, self._base, self.step = rng, list(rng), int(state["step"])

    def skip(self, steps: int) -> None:
        """Advance the step count by ``steps`` without drawing (what the
        draws of those steps would have taken)."""
        if self.schedule == "fused":
            self._i += steps
        else:
            self.step += steps


# -- the committed fixture of JAX's draws (tests/test_torch_prng.py --write) ------

DRAWS_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
    "jax_draws.npz")
FIXTURE_ROWS = 6796        # the training split of the 8,496-sample set
FIXTURE_T = 5              # video tokens at ModelConfig() width
FIXTURE_SAMPLES = 256      # sampled elements a mask
FIXTURE_BITS, FIXTURE_BITS_SEED = 1 << 20, 42
# Each case: the schedule, its seeds (lanes when more than one), the global
# batch, the epochs drawn and the steps of each epoch whose draws are kept;
# "alpha" (the fused schedule): mixup's α, with modality dropout on.
FIXTURE_CASES = {
    "loop": {"schedule": "loop", "seeds": [0], "batch": 64, "epochs": 2,
             "steps": [0, 3]},
    "fused": {"schedule": "fused", "seeds": [0], "batch": 64, "epochs": 1,
              "steps": [0, 1], "alpha": 0.4},
    "lanes": {"schedule": "fused", "seeds": [0, 1, 2, 3], "batch": 64,
              "epochs": 1, "steps": [0]},
    "global256": {"schedule": "loop", "seeds": [0], "batch": 256, "epochs": 1,
                  "steps": [0]},
}


def sample_mask(n: int) -> np.ndarray:
    """The fixture's sampled flat indices of an ``n``-element draw: its
    first and last and ``FIXTURE_SAMPLES - 2`` from
    ``np.random.RandomState(n)`` (a stream numpy keeps frozen), sorted."""
    if n <= FIXTURE_SAMPLES:
        return np.arange(n)
    drawn = np.random.RandomState(n % 2 ** 32).randint(0, n, FIXTURE_SAMPLES - 2)
    return np.unique(np.concatenate([[0, n - 1], drawn]))


def fixture_draws(device: torch.device | str, fx,
                  cases: Optional[Sequence[str]] = None) -> dict:
    """This device's draws of the fixture's cases (all, or ``cases``; "bits"
    is the 32-bit bits case) beside the fixture's: ``{name: (ours, JAX's)}``
    as numpy arrays, the masks at the sampled indices."""
    device = torch.device(device)
    out = {}
    for name, case in FIXTURE_CASES.items():
        if cases is not None and name not in cases:
            continue
        alpha = case.get("alpha", 0.0)
        tcfg = TrainConfig(mixup_alpha=alpha,
                           modality_dropout=0.3 if alpha else 0.0)
        lanes = len(case["seeds"]) > 1
        ks = KeySchedule(case["seeds"], case["schedule"], ModelConfig(), tcfg,
                         case["batch"], FIXTURE_T, device, lanes=lanes)
        steps = -(-FIXTURE_ROWS // case["batch"])
        for epoch in range(case["epochs"]):
            perm, lams = ks.begin_epoch(FIXTURE_ROWS, steps)
            done = 0
            for i in sorted(case["steps"]):
                ks.skip(i - done)
                rand, done = ks.draw(), i + 1
                for lane in range(len(case["seeds"])):
                    tag = f"{name}/{lane}/e{epoch}"
                    pick = (lambda x: x[lane]) if lanes else (lambda x: x)
                    for k, m in enumerate(rand.masks):
                        m = pick(m).reshape(-1)
                        idx = torch.from_numpy(sample_mask(m.numel())).to(device)
                        out[f"{tag}/s{i}/mask{k}"] = (
                            (m[idx] > 0).cpu().numpy(), fx[f"{tag}/s{i}/mask{k}"])
                    if rand.u is not None:
                        out[f"{tag}/s{i}/u"] = (pick(rand.u).cpu().numpy(),
                                                fx[f"{tag}/s{i}/u"])
                    if rand.j is not None:
                        out[f"{tag}/s{i}/j"] = (pick(rand.j).cpu().numpy(),
                                                fx[f"{tag}/s{i}/j"].astype(np.int64))
            ks.skip(steps - done)
            for lane in range(len(case["seeds"])):
                tag = f"{name}/{lane}/e{epoch}"
                pick = (lambda x: x[lane]) if lanes else (lambda x: x)
                out[f"{tag}/perm"] = (pick(perm).cpu().numpy(),
                                      fx[f"{tag}/perm"].astype(np.int64))
                if lams is not None:
                    out[f"{tag}/lam"] = (pick(lams).cpu().numpy(), fx[f"{tag}/lam"])
    if cases is None or "bits" in cases:
        bits = prng.random_bits(prng.PRNGKey(FIXTURE_BITS_SEED), torch.arange(
            FIXTURE_BITS, dtype=torch.int64, device=device))
        idx = torch.from_numpy(sample_mask(FIXTURE_BITS)).to(device)
        out["bits"] = (bits[idx].cpu().numpy().astype(np.uint32), fx["bits"])
    return out
