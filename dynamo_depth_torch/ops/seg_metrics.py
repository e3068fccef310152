"""Motion-segmentation PR-sweep counts on the device (port of
``dynamo_depth_tpu.ops.seg_metrics``; reference
``eval/motion_segmentation.py:53-95``).

The thresholds are sorted, so ``pred > thrds[t]`` holds exactly for ``t <
searchsorted(thrds, pred, side='left')``: one bucketization, one histogram
per sample and one suffix sum give tp/fp/fn for every threshold at once.

The counts are float32, summed in the JAX package's order, so that they are
equal to its counts bit for bit even where a sum passes 2^24 and rounds:
each sample's histogram (exact: a sample has fewer than 2^24 pixels), the
batch sum sample after sample, the cumulative sum the way XLA's CPU backend
rewrites ``jnp.cumsum`` (``ReduceWindowRewriter``: sequential sums within
blocks of 16, plus the sum of the blocks before, by the same rule) and the
total the way it rewrites ``jnp.sum`` (:func:`_sum_f32`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SCAN_BLOCK = 16
_SUM_BLOCK = 32


def _sequential_sum(x):
    """Sum over the last axis, one element after another."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _cumsum_f32(x):
    """Inclusive cumulative sum of a 1-D float32 tensor, in XLA's order."""
    n = x.shape[0]
    rows = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, rows * _SCAN_BLOCK - n)).reshape(rows, _SCAN_BLOCK)
    cols = [blocks[:, 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + blocks[:, j])
    within = torch.stack(cols, dim=1)
    if rows == 1:
        return within.reshape(-1)[:n]
    # Sum of the blocks before each block: exclusive, by the same rule.
    before = torch.cat([torch.zeros_like(within[:1, -1]), _cumsum_f32(within[:-1, -1])])
    return (within + before[:, None]).reshape(-1)[:n]


def pr_sweep_counts(pred, gt, thrds, sample_weight=None):
    """tp/fp/fn over a batch for every threshold at once.

    :param pred:  ``(B, H, W)`` float32 motion probability
    :param gt:    ``(B, H, W)`` integer labels (1 moving, 2 static, 3 unlabeled)
    :param thrds: ``(T,)`` thresholds, sorted ascending
    :param sample_weight: optional ``(B,)`` 1/0 weights that drop padded samples
    :return: (tp, fp, fn), each ``(T,)`` float32 on ``pred``'s device
    """
    B = pred.shape[0]
    T = thrds.shape[0]
    dev = pred.device
    thrds = torch.as_tensor(thrds, dtype=torch.float32, device=dev)
    gt = torch.as_tensor(gt, device=dev).reshape(B, -1)
    if sample_weight is None:
        sample_weight = torch.ones((B,), dtype=torch.float32, device=dev)
    w = torch.as_tensor(sample_weight, dtype=torch.float32, device=dev)[:, None]
    gm = (gt == 1).float() * w
    vm = (gt != 3).float() * w

    # b: how many thresholds lie strictly below pred; pred > thrds[t] iff t < b.
    b = torch.searchsorted(thrds, pred.reshape(B, -1).contiguous(), right=False)

    def hist(mask):
        per_sample = torch.zeros((B, T + 1), dtype=torch.float32, device=dev).scatter_add_(1, b, mask)
        return _sequential_sum(per_sample.t())

    def suffix_counts(h):
        # counts[t] = sum of h[b] over b > t
        c = _cumsum_f32(h)
        return c[-1] - c[:-1]

    hg, hv = hist(gm), hist(vm)
    tp = suffix_counts(hg)
    p_sum = suffix_counts(hv)
    g_sum = _sum_f32(hg)
    return tp, p_sum - tp, g_sum - tp


def _sum_f32(x):
    """Sum of a 1-D float32 tensor in XLA's order (``TreeReductionRewriter``):
    centred zero padding to blocks of 32, each block summed in sequence, then
    the block sums by the same rule."""
    n = x.shape[0]
    if n <= _SUM_BLOCK:
        return _sequential_sum(x)
    padded = -(-n // _SUM_BLOCK) * _SUM_BLOCK
    lo = (padded - n) // 2
    return _sum_f32(_sequential_sum(F.pad(x, (lo, padded - n - lo)).reshape(-1, _SUM_BLOCK)))
