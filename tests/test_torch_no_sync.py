"""The port's training step on the card makes no synchronising call, so the
host can queue steps ahead of the card; and ``project``'s memoised divisor
is bit-equal there to a fresh one.

Marked ``cuda``: every test skips without an NVIDIA card. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_no_sync.py -q

After one warm-up step (which builds the memoised divisors), a ``fine_tune``
step on a synthetic batch runs under ``torch.cuda.set_sync_debug_mode
("error")``, which raises at any call that waits for the stream: a pageable
host-to-device copy, ``.item()``, ``nonzero``, boolean-mask indexing.
"""

import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from torch_project_cases import assert_project_bit_equal

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("height,width", [(192, 640), (7, 13)])
def test_project_bit_equal_on_card(dev, height, width, dtype):
    assert_project_bit_equal(height, width, dtype, dev)


# b12 warps bfloat16 source images (image_dtype auto), b3 float32 ones.
@pytest.mark.parametrize("depth_model,batch", [("litemono", 3), ("monodepthv2", 3), ("litemono", 12)])
def test_fine_tune_step_makes_no_sync(dev, depth_model, batch):
    H, W = 192, 640
    cfg = DynamoConfig(dataset="kitti", depth_model=depth_model, height=H, width=W, batch_size=batch,
                       weights_init="scratch")
    trainer = Trainer(cfg, device="cuda", phase="fine_tune", steps_per_epoch=8000)
    data = trainer.to_device(synthetic_batch(cfg, batch, H, W, seed=0))
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer.train_step(data, gen, 0)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = trainer.train_step(data, gen, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out["loss"]).item()
