"""The JAX package's random initialisation, drawn for the port's modules.

The JAX modules take flax's defaults, and a few name them explicitly
(``dynamo_depth_tpu/models/layers.py:87``, ``litemono.py:89``,
``motion_decoder.py:58-61``):

- conv and dense kernels: ``lecun_normal``, i.e. ``variance_scaling(1,
  "fan_in", "truncated_normal")``: a normal of std
  ``sqrt(1 / fan_in) / 0.87962566`` truncated at two of its stds, whose
  variance after truncation is ``1 / fan_in``;
- biases: zeros;
- BatchNorm and LayerNorm: scale ones, bias zeros;
- LiteMono's layer scales ``gamma`` and ``gamma_xca``: 1e-6; the XCA
  ``temperature``: ones.

torch's defaults differ (``kaiming_uniform_`` with a = sqrt(5), variance
``1 / (3 fan_in)``, and uniform non-zero biases). :func:`init_like_jax`
overwrites every parameter of a module with a draw from its flax
counterpart's distribution; fan_in is ``in_channels / groups * kh * kw``,
which is flax's ``kh * kw * cin_per_group`` for the depthwise and grouped
convs too.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn as nn

from dynamo_depth_torch.models.litemono import LGFI, XCA, DilatedConv

# The std of a standard normal truncated to [-2, 2] (flax's constant).
_TRUNCATED_STD = 0.87962566103423978
LAYER_SCALE_INIT = 1e-6


@contextlib.contextmanager
def _one_thread():
    """torch's intra-op pool cut to the calling thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: variance ``1 / fan_in`` after
    truncation at two stds of the untruncated normal. Drawn as
    ``jax.random.truncated_normal`` draws, through the inverse CDF: one
    uniform draw per entry between the CDF's values at -2 and 2, mapped by
    erfinv (``nn.init.trunc_normal_`` of recent torch rejects and redraws,
    several times slower on the CPU).

    erfinv runs on the calling thread alone. On the CPU torch splits it
    over the intra-op pool even for a few thousand entries, and the first
    such call in a process was seen to return some worker threads' chunks
    off by up to 5e-5 (3 fresh processes of 400, torch 2.13, 8 threads;
    never on one thread, nor on a later call): two processes drawing from
    one seed then held different weights."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    edge = math.erf(2.0 / math.sqrt(2.0))
    weight.uniform_(-edge, edge, generator=generator)
    with _one_thread():
        weight.erfinv_()
    weight.mul_(std * math.sqrt(2.0))
    return weight.clamp_(-2.0 * std, 2.0 * std)


def fan_in(module: nn.Module) -> int:
    """The fan_in of a conv's or a dense layer's kernel, as flax counts it."""
    if isinstance(module, nn.Conv2d):
        return module.in_channels // module.groups * math.prod(module.kernel_size)
    return module.in_features


@torch.no_grad()
def init_like_jax(model: nn.Module, generator: Optional[torch.Generator] = None) -> List[str]:
    """Draw every parameter of ``model`` in place from the distribution the
    JAX package gives its counterpart, from ``generator`` (None: torch's
    default generator). Returns the names of the parameters that no rule
    covered (empty for every module of the port)."""
    covered = set()

    def fill(p: torch.Tensor, value: float) -> None:
        p.fill_(value)
        covered.add(id(p))

    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            lecun_normal_(module.weight, fan_in(module), generator)
            covered.add(id(module.weight))
            if module.bias is not None:
                fill(module.bias, 0.0)
        elif isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
            fill(module.weight, 1.0)
            fill(module.bias, 0.0)
        if isinstance(module, (DilatedConv, LGFI)):
            fill(module.gamma, LAYER_SCALE_INIT)
        if isinstance(module, LGFI):
            fill(module.gamma_xca, LAYER_SCALE_INIT)
        if isinstance(module, XCA):
            fill(module.temperature, 1.0)
    return [name for name, p in model.named_parameters() if id(p) not in covered]
