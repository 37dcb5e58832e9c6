"""Cross-validation splits (port of ``raw2logit_tpu/data/kfold.py``).

Classification: a stratified shuffle split, the reference's
``sklearn.model_selection.StratifiedShuffleSplit``, written out here
because the port does not depend on scikit-learn. It draws from
``np.random.RandomState(seed)`` in sklearn's order (the train and test
counts per class by ``_approximate_mode``, a permutation per class, then
a permutation of each side), so the folds are sklearn's index for index.
Segmentation: a seeded random permutation split.
"""

import math

import numpy as np


def _approximate_mode(class_counts, n_draws, rng):
    """sklearn's approximate mode of the multivariate hypergeometric: the
    floored proportional share of each class, then one more to the classes
    of the largest remainders, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_shuffle_split(labels, n_splits, train_size, seed):
    """``StratifiedShuffleSplit(n_splits, train_size=train_size,
    random_state=seed).split(X, labels)`` for a float ``train_size`` in
    (0, 1): a list of (train, test) index arrays."""
    labels = np.asarray(labels)
    n = len(labels)
    if not 0 < train_size < 1:
        raise ValueError(f"train_size={train_size} should be in (0, 1)")
    n_train = math.floor(train_size * n)
    n_test = n - n_train
    if n_train == 0:
        raise ValueError(f"with {n} samples and train_size={train_size} the "
                         f"train set is empty")
    classes, y_indices, class_counts = np.unique(
        labels, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(f"the least populated classes have only 1 member: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must "
                         f"be at least the number of classes "
                         f"({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    splits = []
    for _ in range(n_splits):
        n_i = _approximate_mode(class_counts, n_train, rng)
        t_i = _approximate_mode(class_counts - n_i, n_test, rng)
        train, test = [], []
        for i in range(len(classes)):
            perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                         mode="clip")
            train.extend(perm[:n_i[i]])
            test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
        splits.append((rng.permutation(train), rng.permutation(test)))
    return splits


def k_fold(dataset, n_splits, seed, train_size):
    """-> list of (train_indices, valid_indices), n_splits pairs."""
    if dataset.task == "classification":
        return [(tr.tolist(), va.tolist())
                for tr, va in stratified_shuffle_split(
                    list(dataset.labels), n_splits, train_size, seed)]

    rng = np.random.default_rng(seed)
    idxs = []
    split = int(len(dataset) * train_size)
    for _ in range(n_splits):
        perm = rng.permutation(len(dataset))
        idxs.append((perm[:split].tolist(), perm[split:].tolist()))
    return idxs
