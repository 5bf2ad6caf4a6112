"""Adam over a stacked [S, P] f32 parameter buffer, one optimizer state per
client (the port of `optax.adam(lr)` as the round engine vmaps it).

optax's arithmetic, written out in f32: b1 0.9, b2 0.999, eps 1e-8,
eps_root 0;
    mu = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
    count += 1 (int32, saturating)
    mu_hat = mu / (1 - b1^count)     nu_hat = nu / (1 - b2^count)
    p = p + (-lr) mu_hat / (sqrt(nu_hat + eps_root) + eps)
Each client's `count` is its own and advances only where `step` is true:
a padded batch or an early-stopped client passes its params and state
through unchanged.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.models.flat import ParamLayout

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
_COUNT_MAX = np.iinfo(np.int32).max


class AdamState(NamedTuple):
    count: torch.Tensor  # [S] int32
    mu: torch.Tensor     # [S, P] f32
    nu: torch.Tensor     # [S, P] f32

    def take(self, idx: torch.Tensor) -> "AdamState":
        return AdamState(*(t.index_select(0, idx) for t in self))

    def put(self, idx: torch.Tensor, sub: "AdamState") -> "AdamState":
        return AdamState(*(t.index_copy(0, idx, s) for t, s in zip(self, sub)))

    def where(self, keep_new: torch.Tensor, old: "AdamState") -> "AdamState":
        """Rows of self where keep_new [S] is true, of `old` elsewhere."""
        return AdamState(*(torch.where(_rows(keep_new, a), a, b)
                           for a, b in zip(self, old)))


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def adam_init(params: torch.Tensor) -> AdamState:
    return AdamState(
        count=torch.zeros(params.shape[0], dtype=torch.int32,
                          device=params.device),
        mu=torch.zeros_like(params), nu=torch.zeros_like(params))


def adam_step(params: torch.Tensor, state: AdamState, grads: torch.Tensor,
              step: torch.Tensor, lr: float) -> Tuple[torch.Tensor, AdamState]:
    """One Adam update of the rows where `step` [S] is true; the others
    keep their params and state."""
    mu = (1 - B1) * grads + B1 * state.mu
    nu = (1 - B2) * (grads * grads) + B2 * state.nu
    count = torch.where(state.count < _COUNT_MAX, state.count + 1,
                        state.count)
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(cf, B1), cf)
    bc2 = 1 - torch.pow(torch.full_like(cf, B2), cf)
    mu_hat = mu / bc1[:, None]
    nu_hat = nu / bc2[:, None]
    updates = (-lr) * (mu_hat / (torch.sqrt(nu_hat + EPS_ROOT) + EPS))
    keep = step[:, None]
    return (torch.where(keep, params + updates, params),
            AdamState(count, mu, nu).where(step, state))


def opt_state_from_numpy(opt_state: Any, layout: ParamLayout, *,
                         device: torch.device) -> AdamState:
    """The port's state from optax's adam state as numpy: the
    ScaleByAdamState (count [N], mu and nu param trees with leaves [N, ...])
    or any tuple holding it, as `optax.adam` chains it."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the optimizer "
                         "state given")
    flat = lambda tree: layout.flatten(_tensors(tree)).to(device)  # noqa: E731
    return AdamState(
        count=torch.as_tensor(np.asarray(adam.count, np.int32)).to(device),
        mu=flat(adam.mu), nu=flat(adam.nu))


def opt_state_to_numpy(state: AdamState, layout: ParamLayout) -> dict:
    """{"count": [N] int32, "mu": tree, "nu": tree} as numpy: the fields
    of optax's ScaleByAdamState."""
    tree = lambda t: _numpy(layout.tree(t.detach().cpu()))  # noqa: E731
    return {"count": state.count.cpu().numpy().astype(np.int32),
            "mu": tree(state.mu), "nu": tree(state.nu)}


def _find_adam(state: Any) -> Any:
    if hasattr(state, "mu") and hasattr(state, "count"):
        return state
    if isinstance(state, (tuple, list)):
        for part in state:
            found = _find_adam(part)
            if found is not None:
                return found
    return None


def _tensors(tree: Any) -> Any:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()
