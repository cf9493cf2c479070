"""Synthetic data generation and the non-IID partition, without scikit-learn.

The JAX package draws its data with scikit-learn's ``make_classification``
and ``make_regression`` and standardises with ``StandardScaler``
(``distributed_optimization_tpu/utils/data.py``). The machines the port
runs on need not have scikit-learn, so this module reproduces both
generators in numpy, draw for draw, on one ``np.random.RandomState`` seeded
with ``config.resolved_data_seed()``: the same seed gives the same labels
and the same partition, and features equal to the last bits of the
standardisation sums.

The two generators follow the algorithm of scikit-learn 1.9's
``sklearn/datasets/_samples_generator.py`` and
``sklearn/utils/_random.pyx`` (``sample_without_replacement``).
scikit-learn is distributed under the BSD 3-Clause licence; Copyright (c)
2007-2024 The scikit-learn developers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HostDataset:
    """Full dataset + per-worker partition, host-side (numpy, float64)."""

    X_full: np.ndarray  # [n_samples, d] standardized, bias column appended
    y_full: np.ndarray  # [n_samples] (±1 for logistic, class indices for softmax)
    shard_indices: list[np.ndarray]  # per-worker row indices into X_full
    problem_type: str

    @property
    def n_features(self) -> int:
        return self.X_full.shape[1]

    @property
    def n_workers(self) -> int:
        return len(self.shard_indices)

    def shard(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.shard_indices[i]
        return self.X_full[idx], self.y_full[idx]


@dataclasses.dataclass(frozen=True)
class DeviceDataset:
    """Stacked, padded per-worker shards: ``X [N, L, d]``, ``y [N, L]``,
    ``n_valid [N]``; rows at index >= n_valid[i] are zero padding. X and y
    are numpy arrays, or CPU torch tensors in bfloat16 (``stack_shards``)."""

    X: np.ndarray | torch.Tensor
    y: np.ndarray | torch.Tensor
    n_valid: np.ndarray

    @property
    def n_workers(self) -> int:
        return self.X.shape[0]

    @property
    def n_features(self) -> int:
        return self.X.shape[2]


# --- scikit-learn's generators, redrawn in numpy ---------------------------


def _sample_without_replacement(
    n_population: int, n_samples: int, rng: np.random.RandomState
) -> np.ndarray:
    """``sample_without_replacement(method='auto')``: a permutation prefix
    for ratios in (0.01, 0.99), else set-tracked rejection below 0.2 and
    reservoir sampling above it."""
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, dtype=np.int64)
    if ratio < 0.2:
        selected: set[int] = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
        return out
    out[:] = np.arange(n_samples)
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def _generate_hypercube(
    samples: int, dimensions: int, rng: np.random.RandomState
) -> np.ndarray:
    """Distinct binary vertices: random bits above 30 dimensions, then the
    low 30 bits of integers drawn without replacement."""
    if dimensions > 30:
        return np.hstack([
            rng.randint(2, size=(samples, dimensions - 30)),
            _generate_hypercube(samples, 30, rng),
        ])
    out = _sample_without_replacement(2**dimensions, samples, rng).astype(
        ">u4", copy=False
    )
    return np.unpackbits(out.view(">u1")).reshape((-1, 32))[:, -dimensions:]


def _shuffle_rows_then_features(X, y, rng):
    """The generators' final shuffle: a row permutation of (X, y), then a
    permutation of the feature columns."""
    order = np.arange(X.shape[0])
    rng.shuffle(order)
    X, y = X[order], y[order]
    columns = np.arange(X.shape[1])
    rng.shuffle(columns)
    X[:, :] = X[:, columns]
    return X, y


def make_classification(
    n_samples: int,
    n_features: int,
    n_informative: int,
    n_redundant: int,
    *,
    n_classes: int = 2,
    n_clusters_per_class: int = 1,
    flip_y: float = 0.05,
    class_sep: float = 1.0,
    seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``make_classification`` with ``hypercube=True``,
    ``n_repeated=0``, ``shift=0``, ``scale=1``, ``shuffle=True``."""
    rng = np.random.RandomState(seed)
    if n_informative + n_redundant > n_features:
        raise ValueError(
            "informative + redundant features exceed n_features"
        )
    n_clusters = n_classes * n_clusters_per_class
    if n_informative < np.log2(n_clusters):
        raise ValueError(
            f"n_classes * n_clusters_per_class ({n_clusters}) must be <= "
            f"2**n_informative ({2**n_informative})"
        )
    n_random = n_features - n_informative - n_redundant
    per_cluster = [
        int(n_samples * (1.0 / n_classes) / n_clusters_per_class)
        for _ in range(n_clusters)
    ]
    for i in range(n_samples - sum(per_cluster)):
        per_cluster[i % n_clusters] += 1

    X = np.zeros((n_samples, n_features))
    y = np.zeros(n_samples, dtype=int)
    centroids = _generate_hypercube(n_clusters, n_informative, rng).astype(
        float, copy=False
    )
    centroids *= 2 * class_sep
    centroids -= class_sep

    X[:, :n_informative] = rng.standard_normal(size=(n_samples, n_informative))
    stop = 0
    for k, centroid in enumerate(centroids):
        start, stop = stop, stop + per_cluster[k]
        y[start:stop] = k % n_classes
        X_k = X[start:stop, :n_informative]
        A = 2 * rng.uniform(size=(n_informative, n_informative)) - 1
        X_k[...] = np.dot(X_k, A)  # the cluster's random covariance
        X_k += centroid

    if n_redundant > 0:
        B = 2 * rng.uniform(size=(n_informative, n_redundant)) - 1
        X[:, n_informative:n_informative + n_redundant] = np.dot(
            X[:, :n_informative], B
        )
    if n_random > 0:
        X[:, -n_random:] = rng.standard_normal(size=(n_samples, n_random))

    if flip_y >= 0.0:
        flip_mask = rng.uniform(size=n_samples) < flip_y
        y[flip_mask] = rng.randint(n_classes, size=flip_mask.sum())

    # shift=0 and scale=1 leave X unchanged (adding 0.0, multiplying by 1.0).
    return _shuffle_rows_then_features(X, y, rng)


def make_regression(
    n_samples: int,
    n_features: int,
    n_informative: int,
    *,
    noise: float = 0.0,
    seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``make_regression`` with one target, ``bias=0``,
    ``effective_rank=None`` and ``shuffle=True``."""
    rng = np.random.RandomState(seed)
    n_informative = min(n_features, n_informative)
    X = rng.standard_normal(size=(n_samples, n_features))
    ground_truth = np.zeros((n_features, 1))
    ground_truth[:n_informative, :] = 100 * rng.uniform(size=(n_informative, 1))
    y = np.dot(X, ground_truth) + 0.0
    if noise > 0.0:
        y += rng.normal(scale=noise, size=y.shape)
    X, y = _shuffle_rows_then_features(X, y, rng)
    return X, np.squeeze(y)


# --- the study's dataset ----------------------------------------------------


def _standardize(X: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance per column (ddof=0); a constant column
    keeps scale 1, as ``StandardScaler`` leaves it."""
    mean = X.mean(axis=0)
    std = X.std(axis=0)
    std[std == 0.0] = 1.0
    return (X - mean) / std


def generate_synthetic_dataset(config) -> HostDataset:
    """The study's synthetic dataset and its partition over the workers.

    Same hyperparameters as the JAX package (n_redundant = n_features −
    n_informative, one cluster per class, flip_y=0.05, noise=10 for the
    regression of quadratic and huber), labels mapped to ±1 for logistic
    and kept as class indices for softmax, standardisation, a bias column,
    then
    ``argsort(y)`` (``partition='sorted'``, the non-IID split) or a
    ``default_rng(data seed)`` permutation (``'shuffled'``, the IID split)
    cut contiguously over the workers.
    """
    seed = config.resolved_data_seed()
    if config.problem_type == "logistic":
        X, y = make_classification(
            config.n_samples,
            config.n_features,
            config.n_informative_features,
            config.n_features - config.n_informative_features,
            n_clusters_per_class=1,
            flip_y=0.05,
            class_sep=config.classification_sep,
            seed=seed,
        )
        y = y.astype(np.float64) * 2.0 - 1.0
    elif config.problem_type == "softmax":
        # The logistic generator with K classes; the labels stay the class
        # indices 0 … K−1 (stored as int32 on the device: stack_shards).
        if config.n_classes > 2**config.n_informative_features:
            raise ValueError(
                f"n_classes ({config.n_classes}) exceeds what "
                f"{config.n_informative_features} informative features can "
                "separate (sklearn make_classification requires n_classes "
                "<= 2^n_informative)"
            )
        X, y = make_classification(
            config.n_samples,
            config.n_features,
            config.n_informative_features,
            config.n_features - config.n_informative_features,
            n_classes=config.n_classes,
            n_clusters_per_class=1,
            flip_y=0.05,
            class_sep=config.classification_sep,
            seed=seed,
        )
        y = y.astype(np.float64)
    elif config.problem_type in ("quadratic", "huber"):
        # Huber shares the regression data (its δ is the noise's scale).
        X, y = make_regression(
            config.n_samples,
            config.n_features,
            config.n_informative_features,
            noise=10.0,
            seed=seed,
        )
        y = y.astype(np.float64)
    else:
        raise ValueError(
            f"problem_type={config.problem_type!r}: the PyTorch port does "
            "not have it yet"
        )

    X = _standardize(X)
    X = np.hstack([X, np.ones((X.shape[0], 1))])  # bias column: d -> d+1
    if config.partition == "shuffled":
        order = np.random.default_rng(seed).permutation(y.shape[0])
    else:
        order = np.argsort(y)
    shard_indices = [
        np.asarray(s) for s in np.array_split(order, config.n_workers)
    ]
    return HostDataset(
        X_full=X, y_full=y, shard_indices=shard_indices,
        problem_type=config.problem_type,
    )


def stack_shards(dataset: HostDataset, dtype=np.float32) -> DeviceDataset:
    """Stack the ragged shards into zero-padded ``[N, L, d]`` arrays.

    ``dtype`` names the run dtype (a string, numpy or torch dtype). X and a
    scalar family's y are stored in it; softmax's labels are class indices,
    stored as int32 in every dtype, as the JAX package stores them (under
    bfloat16 every odd label above 256 would round). numpy has no
    bfloat16, so a bfloat16 stack is stacked in float64 and cast by torch,
    bit for bit the JAX package's ml_dtypes cast: X and y are then CPU
    torch tensors (y int32 numpy under softmax), f32/f64 stacks numpy
    arrays."""
    n = dataset.n_workers
    d = dataset.n_features
    sizes = np.array([len(idx) for idx in dataset.shard_indices], dtype=np.int32)
    L = int(sizes.max()) if n else 0
    name = (str(dtype).removeprefix("torch.") if isinstance(dtype, (str, torch.dtype))
            else np.dtype(dtype).name)
    bf16 = name == "bfloat16"
    stack = np.dtype(np.float64 if bf16 else name)
    softmax = dataset.problem_type == "softmax"
    X = np.zeros((n, L, d), dtype=stack)
    y = np.zeros((n, L), dtype=np.int32 if softmax else stack)
    for i in range(n):
        Xi, yi = dataset.shard(i)
        X[i, : sizes[i]] = Xi
        y[i, : sizes[i]] = yi
    if bf16:
        X = torch.from_numpy(X).to(torch.bfloat16)
        if not softmax:
            y = torch.from_numpy(y).to(torch.bfloat16)
    return DeviceDataset(X=X, y=y, n_valid=sizes)
