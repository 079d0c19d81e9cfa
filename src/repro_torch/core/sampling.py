"""Random-sampling group strategy + k-fold split (paper §4, §5.2) — a numpy
copy of ``repro.core.sampling``: the same seed gives the same groups."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GroupedData:
    groups: np.ndarray        # [n_groups, group_size, d]
    train_idx: np.ndarray     # indices into groups
    val_idx: np.ndarray

    @property
    def train_groups(self):
        return self.groups[self.train_idx]

    @property
    def val_groups(self):
        return self.groups[self.val_idx]


def random_groups(data: np.ndarray, group_size: int, *, seed: int = 0,
                  max_groups: int | None = None) -> np.ndarray:
    """Shuffle and split into ⌊n/group_size⌋ equal groups (drop remainder)."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    n_groups = n // group_size
    if max_groups is not None:
        n_groups = min(n_groups, max_groups)
    perm = rng.permutation(n)[: n_groups * group_size]
    return data[perm].reshape(n_groups, group_size, data.shape[-1])


def kfold_split(n_groups: int, fold: int = 0, n_folds: int = 10, *,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """10-fold CV over *groups* (paper §5.2). Returns (train_idx, val_idx)."""
    if not 0 <= fold < n_folds:
        raise ValueError(f"fold {fold} out of range for {n_folds} folds")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_groups)
    folds = np.array_split(perm, n_folds)
    val = folds[fold]
    train = np.concatenate([f for i, f in enumerate(folds) if i != fold])
    return np.sort(train), np.sort(val)


def make_grouped(data: np.ndarray, group_size: int, *, fold: int = 0,
                 n_folds: int = 10, seed: int = 0,
                 max_groups: int | None = None) -> GroupedData:
    groups = random_groups(data, group_size, seed=seed, max_groups=max_groups)
    train, val = kfold_split(groups.shape[0], fold, n_folds, seed=seed + 1)
    return GroupedData(groups=groups, train_idx=train, val_idx=val)
