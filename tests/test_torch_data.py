"""The port's data pipeline against the JAX package's, on the vendored
``assets/tiny_*`` fixtures: dataset items of all three datasets (equal
exactly, with augmentation on and off, from the same numpy rng), the epoch
draw, the batch loader's order, sharding and per-item rngs, split
resolution, and the native decoder against PIL."""

import os.path as osp

import numpy as np
import pytest

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.data import DATASETS as T_DATASETS
from dynamo_depth_torch.data import base as t_base
from dynamo_depth_torch.data import loader as t_loader
from dynamo_depth_torch.data import native as t_native
from dynamo_depth_torch.data import splits as t_splits
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.data import DATASETS as J_DATASETS
from dynamo_depth_tpu.data import loader as j_loader
from dynamo_depth_tpu.data import splits as j_splits
from torch_test_threads import two_torch_threads  # noqa: F401

ASSETS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "assets")
KITTI_SEQ = "2011_09_26/2011_09_26_drive_0001_sync"
WAYMO_SEG = "val/segment-0000000000_tiny_fixture"

# dataset -> (constructor arguments, filenames, frame ids); each item's
# frames and, where asked, its depth points and masks exist in the fixture.
CASES = {
    "kitti": (dict(data_path=osp.join(ASSETS, "tiny_kitti") + "/", height=64, width=192, cam_name="image_02",
                   img_ext=".jpg", load_depth=True, load_mask=True),
              [f"{KITTI_SEQ} 0 l", f"{KITTI_SEQ} 1 r", f"{KITTI_SEQ} 1 l"], [0, -1, 1]),
    "waymo": (dict(data_path=osp.join(ASSETS, "tiny_waymo") + "/", height=64, width=96, cam_name="FRONT",
                   img_ext=".jpg", load_depth=True, load_mask=True),
              [f"{WAYMO_SEG} 1"], [0, -1, 1]),
    "nuscenes": (dict(data_path=osp.join(ASSETS, "tiny_nuscenes") + "/", height=64, width=128, cam_name="FRONT",
                      img_ext=".jpg", load_depth=True, load_mask=True),
                 ["scenes/scene-0001 0"], [0, 1]),
}


def _datasets(name, is_train, filenames=None):
    kw, files, frames = CASES[name]
    common = dict(kw, filenames=filenames or files, img_type="downsample", frame_idxs=frames, num_scales=3,
                  is_train=is_train, seed=3)
    return J_DATASETS[name](**common), T_DATASETS[name](**common)


def _assert_items_equal(ref, got):
    assert list(ref) == list(got)
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_items_equal_the_jax_packages(name, is_train):
    j_ds, t_ds = _datasets(name, is_train)
    variants = []  # distinct augmented images of each item over the seeds
    for index in range(len(t_ds)):
        seen = set()
        for seed in range(4):
            ref = j_ds.get_item(index, rng=np.random.RandomState(seed))
            got = t_ds.get_item(index, rng=np.random.RandomState(seed))
            _assert_items_equal(ref, got)
            seen.add(got[("color_aug", 0, 0)].tobytes())
        variants.append(len(seen))
        _assert_items_equal(j_ds[index], t_ds[index])  # the per-index default rng
    # Training draws flip and jitter; evaluation draws nothing.
    assert max(variants) > 1 if is_train else variants == [1] * len(t_ds)


@pytest.mark.parametrize("epoch_size,global_batch,seed,pool", [(3, 3, 0, 4), (2, 1, 5, 4), (10, 4, 1, 100), (0, 2, 0, 7)])
def test_epoch_draw_equals_the_jax_packages(epoch_size, global_batch, seed, pool):
    files = [f"seg {i}" for i in range(pool)]
    assert (t_loader.sample_epoch_filenames(files, epoch_size, global_batch, seed)
            == j_loader.sample_epoch_filenames(files, epoch_size, global_batch, seed))


class _IndexDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_item(self, i, rng=None):
        # The item records the rng the loader handed it, where it got one.
        return {"i": np.array([i]), "draw": np.array([-1 if rng is None else rng.randint(1 << 30)])}


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_loader_order_sharding_and_rngs_equal_the_jax_packages(shuffle, shard):
    for epoch in (0, 3):
        loaders = []
        for mod in (j_loader, t_loader):
            loader = mod.BatchLoader(_IndexDataset(13), 3, shuffle=shuffle, num_workers=2, seed=4, shard=shard)
            loader.set_epoch(epoch)
            loaders.append(loader)
        ref, got = ([{k: v.tolist() for k, v in b.items()} for b in loader] for loader in loaders)
        assert len(loaders[1]) == len(loaders[0]) == len(got)
        assert got == ref and got


def test_batches_of_tiny_kitti_equal_the_jax_packages():
    j_ds, t_ds = _datasets("kitti", True, [f"{KITTI_SEQ} {i} {s}" for i in (0, 1) for s in "lr"])
    ref = list(j_loader.BatchLoader(j_ds, 2, shuffle=True, seed=1))
    got = list(t_loader.BatchLoader(t_ds, 2, shuffle=True, seed=1))
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        _assert_items_equal(r, g)


def test_padded_eval_batches_equal_the_jax_packages():
    for shard in ((0, 1), (1, 2)):
        ref = [({k: v.tolist() for k, v in b.items()}, real)
               for b, real in j_loader.padded_eval_batches(_IndexDataset(7), 4, num_workers=2, shard=shard)]
        got = [({k: v.tolist() for k, v in b.items()}, real)
               for b, real in t_loader.padded_eval_batches(_IndexDataset(7), 4, num_workers=2, shard=shard)]
        assert got == ref and got


def test_make_dataset_and_splits_equal_the_jax_packages(tmp_path, monkeypatch):
    split = tmp_path / "tiny"
    split.mkdir()
    (split / "train_files.txt").write_text(f"{KITTI_SEQ} 1 l\n{KITTI_SEQ} 0 r\n")
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", str(tmp_path))
    assert t_splits.read_split("tiny", "train") == j_splits.read_split("tiny", "train")
    assert t_splits.split_exists("tiny", "train") and not t_splits.split_exists("tiny", "val")
    assert not j_splits.split_exists("tiny", "val")
    # The vendored splits fall through behind the override.
    assert t_splits.read_split("eigen_zhou", "test") == j_splits.read_split("eigen_zhou", "test")
    kw = dict(dataset="kitti", data_path=osp.join(ASSETS, "tiny_kitti") + "/", height=64, width=192)
    files = t_splits.read_split("tiny", "train")
    t_ds = t_loader.make_dataset(TConfig(**kw), files, is_train=True, load_depth=True)
    j_ds = j_loader.make_dataset(JConfig(**kw), files, is_train=True, load_depth=True)
    assert type(t_ds).__name__ == type(j_ds).__name__ == "KITTIDataset"
    for i in range(len(files)):
        _assert_items_equal(j_ds[i], t_ds[i])


def test_native_decoder_equals_pil(monkeypatch):
    if not t_native.available():
        pytest.skip(f"the native data plane does not build here: {t_native.build_error}")
    _, t_ds = _datasets("kitti", True)
    t_base.reset_decode_counts()
    native_items = [t_ds.get_item(i, rng=np.random.RandomState(i)) for i in range(len(t_ds))]
    assert t_base.decode_counts() == {"native": 9, "pil": 0}
    monkeypatch.setattr(t_native, "available", lambda: False)
    pil_items = [t_ds.get_item(i, rng=np.random.RandomState(i)) for i in range(len(t_ds))]
    assert t_base.decode_counts() == {"native": 9, "pil": 9}
    for a, b in zip(native_items, pil_items):
        for k in a:
            if isinstance(k, tuple) and k[0] == "color":
                # PIL-parity bicubic resize: at most one 8-bit level apart.
                assert np.abs(a[k] - b[k]).max() <= 1.01 / 255, k
            elif isinstance(k, tuple) and k[0] == "color_aug":
                continue  # the jitter of those, which can amplify that level
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_a_library_that_does_not_load_leaves_pil(monkeypatch, tmp_path):
    # A library built on a machine with libjpeg and libpng, loaded on one
    # without them (or any other file that is not a loadable library).
    lib = tmp_path / "libddt_dataplane.so"
    lib.write_bytes(b"not a shared object")
    monkeypatch.setattr(t_native, "LIB_PATH", lib)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "build_error", None)
    assert not t_native.available()
    assert "does not load" in t_native.build_error
    _, t_ds = _datasets("kitti", True)
    t_base.reset_decode_counts()
    t_ds.get_item(0, rng=np.random.RandomState(0))
    assert t_base.decode_counts()["pil"] > 0 and t_base.decode_counts()["native"] == 0
