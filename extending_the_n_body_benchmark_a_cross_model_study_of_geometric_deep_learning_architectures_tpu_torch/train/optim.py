"""AdamW under a Noam learning-rate schedule, with gradient clipping and the
skip of non-finite updates: counterpart of the JAX package's ``train/optim.py``
(an ``optax`` chain).

* ``torch.optim.AdamW(betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-8)``:
  ``optax.adamw``'s update up to rounding.
* The learning rate is ``learning_rate * factor * size^-0.5 * min(s^-0.5,
  s * warmup^-1.5)`` with ``s = max(count, 1)`` in float32, as the JAX package
  computes it, where ``count`` is the number of updates taken: like optax's
  schedule count, the first two updates both run at ``s = 1``.
* Clip by value (``optax.clip``), then by global norm in optax's form: each
  gradient tensor ``t`` becomes ``t / norm * max_norm`` where ``norm >=
  max_norm`` and stays as it is below.  (``torch.nn.utils.clip_grad_norm_``
  scales by ``max_norm / (norm + 1e-6)`` instead.)
* ``discard_nan_gradients`` is ``optax.apply_if_finite``: an update whose raw
  gradient has a non-finite value is skipped whole, so parameters, moments and
  count stay, and with the count the schedule.  Its three counters are kept
  as optax keeps them (``ApplyIfFiniteState``: the run of non-finite
  gradients, whether the last was finite, the total of non-finite ones), on
  the device; an update that the caller's own decision skips (a non-finite
  prediction) leaves them as they were, as the JAX trainer restores its
  whole optimizer state then.

The skip is decided on the device, without a host sync: the update runs, and
where the decision says so every parameter, moment and count is put back.  So
the count lives on the device, and the schedule reads it there: the learning
rate is a 0-dim tensor that AdamW reads (``capturable`` on the card) and that
each update rewrites from AdamW's own step count.  (``LambdaLR`` counts the
host's calls, which a skip decided on the device cannot hold back without a
sync.)
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

BETAS = (0.9, 0.98)
EPS = 1e-9


def noam_lr(count, learning_rate: float, model_size: int, factor: float = 1.0,
            warmup: int = 1000) -> torch.Tensor:
    """The learning rate after ``count`` updates, a float32 tensor on
    ``count``'s device (an int gives a CPU tensor)."""
    s = torch.clamp(torch.as_tensor(count), min=1).to(torch.float32)
    inv_sqrt = (s.double() ** -0.5).float()  # s^-0.5, rounded once to float32
    mult = factor * model_size ** -0.5 * torch.minimum(inv_sqrt, s * warmup ** -1.5)
    return learning_rate * mult


def noam_schedule(learning_rate: float, model_size: int, factor: float, warmup: int):
    """``count -> learning rate`` as a float, the JAX package's ``noam_schedule``."""
    def schedule(count) -> float:
        return float(noam_lr(count, learning_rate, model_size, factor, warmup))

    return schedule


class NoamAdamW:
    """AdamW over ``params`` under the Noam schedule: ``update(ok)`` after
    ``backward`` takes one update from the parameters' ``.grad``."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float,
        model_size: int,
        factor: float = 1.0,
        warmup: int = 1000,
        clip_value: Optional[float] = None,
        clip_norm: Optional[float] = None,
        discard_nan_gradients: bool = False,
        weight_decay: float = 1e-8,
    ):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = functools.partial(noam_lr, learning_rate=learning_rate,
                                          model_size=model_size, factor=factor, warmup=warmup)
        self.clip_value, self.clip_norm = clip_value, clip_norm
        self.discard_nan_gradients = discard_nan_gradients
        device = self.params[0].device
        self.capturable = device.type == "cuda"  # count and lr stay on the card
        # the float32 schedule value, held in the parameters' dtype: AdamW forms
        # lr / bias correction in the lr's dtype, and the JAX package in the updates'
        self.lr = self.schedule(0).to(device=device, dtype=self.params[0].dtype)
        self.optimizer = torch.optim.AdamW(self.params, lr=self.lr, betas=BETAS, eps=EPS,
                                           weight_decay=weight_decay, capturable=self.capturable)
        # apply_if_finite's notfinite_count, last_finite and total_notfinite
        self.skips = (torch.zeros((), dtype=torch.int32, device=device),
                      torch.ones((), dtype=torch.bool, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))
        self.set_state(0)

    def set_state(self, count: int, exp_avg: Optional[Sequence[torch.Tensor]] = None,
                  exp_avg_sq: Optional[Sequence[torch.Tensor]] = None,
                  skips: Optional[Tuple[int, bool, int]] = None) -> None:
        """Start from ``count`` updates taken and these moments (zeros by
        default), as a resumed run does; the learning rate follows the count.
        ``skips``: ``apply_if_finite``'s counters ``(notfinite_count,
        last_finite, total_notfinite)``, ``(0, True, 0)`` by default."""
        for t, v in zip(self.skips, skips or (0, True, 0)):
            t.fill_(v)
        for i, p in enumerate(self.params):
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if self.capturable else "cpu"),
                "exp_avg": (torch.zeros_like(p) if exp_avg is None
                            else exp_avg[i].to(device=p.device, dtype=p.dtype).clone()),
                "exp_avg_sq": (torch.zeros_like(p) if exp_avg_sq is None
                               else exp_avg_sq[i].to(device=p.device, dtype=p.dtype).clone()),
            }
        self.lr.copy_(self.schedule(count))

    def _step_count(self) -> torch.Tensor:
        return self.optimizer.state[self.params[0]]["step"]

    @property
    def count(self) -> int:
        """Updates taken (a host sync on the card)."""
        return int(self._step_count().item())

    def skip_counts(self) -> Tuple[int, bool, int]:
        """``apply_if_finite``'s counters (a host sync on the card)."""
        nf, last, total = self.skips
        return int(nf.item()), bool(last.item()), int(total.item())

    def moments(self):
        """``(exp_avg, exp_avg_sq)``, each a list in ``params`` order."""
        st = [self.optimizer.state[p] for p in self.params]
        return [s["exp_avg"] for s in st], [s["exp_avg_sq"] for s in st]

    def _count_skips(self, finite: torch.Tensor, ok: Optional[torch.Tensor]) -> None:
        """``apply_if_finite``'s counters after a gradient that is ``finite`` or
        not; kept where the caller's ``ok`` skips the update."""
        nf, last, total = self.skips
        new = (torch.where(finite, torch.zeros_like(nf), nf + 1), finite,
               torch.where(finite, total, total + 1))
        for t, v in zip(self.skips, new):
            t.copy_(v if ok is None else torch.where(ok, v, t))

    @torch.no_grad()
    def update(self, ok: Optional[torch.Tensor] = None) -> None:
        """One update from the gradients.  ``ok`` (a 0-dim bool tensor) skips it
        where false, as a non-finite gradient does under ``discard_nan_gradients``.
        A parameter the loss never reaches (GMN's ``coords_range``) takes a zero
        gradient, as every leaf of the JAX package's tree does: its moments
        decay and its weight decays."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.discard_nan_gradients:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            self._count_skips(finite, ok)
            ok = finite if ok is None else ok & finite
        if self.clip_value is not None:
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            for g in grads:
                g.copy_(torch.where(norm < self.clip_norm, g, g / norm * self.clip_norm))
        if ok is None:
            self.optimizer.step()
        else:
            exp_avg, exp_avg_sq = self.moments()
            steps = [self.optimizer.state[p]["step"] for p in self.params]
            live = [*self.params, *exp_avg, *exp_avg_sq, *steps]
            kept = [t.clone() for t in live]
            self.optimizer.step()
            for t, old in zip(live, kept):
                t.copy_(torch.where(ok, t, old))
        self.lr.copy_(self.schedule(self._step_count()))


def create_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    model_size: int,
    factor: float = 1.0,
    warmup: int = 1000,
    clip_value: Optional[float] = None,
    clip_norm: Optional[float] = None,
    discard_nan_gradients: bool = False,
    weight_decay: float = 1e-8,
) -> NoamAdamW:
    return NoamAdamW(params, learning_rate, model_size, factor, warmup, clip_value, clip_norm,
                     discard_nan_gradients, weight_decay)
