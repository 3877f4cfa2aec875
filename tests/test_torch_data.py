"""The port's data path, utils and checkpoints (phenaki_tpu_torch/data,
phenaki_tpu_torch/utils, phenaki_tpu_torch/training/checkpoint.py) against
the JAX package's, on the CPU:

* `VideoDataset` items equal JAX's exactly on the same GIF and MP4 files,
  on the native route and on the PIL route (the native library hidden from
  both packages), flips off; `ImageDataset` items equal on PNGs (PIL only,
  in both packages); `cast_num_frames`, the collate and `random_split`
  (same seed, same indices) equal;
* codecs: GIFs written by both packages' `video_tensor_to_gif` are
  byte-equal on both routes, decodes and MP4 reads equal; the native
  binding's `transform_image` and `load_gif_batch` equal JAX's;
* utils: `save_image_grid` writes byte-equal PNGs, `psnr` and
  `reconstruction_psnr` (on bridged C-ViViT variables) equal JAX's within
  rtol 1e-6 and 1e-5, `prepare_results_folder` behaves as
  `tests/test_results_folder.py` requires, `MetricLogger`, `accum_log` and
  `profile_trace`;
* the loader and `CheckpointManager` (a failed write leaves the previous
  milestone whole).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import phenaki_tpu.data.codecs as jcodecs  # noqa: E402
import phenaki_tpu.data.datasets as jdatasets  # noqa: E402
import phenaki_tpu.data.native as jnative  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.utils.image_grid import save_image_grid as j_save_image_grid  # noqa: E402
from phenaki_tpu.utils.jit_init import jit_init  # noqa: E402
from phenaki_tpu.utils.metrics import psnr as j_psnr  # noqa: E402
from phenaki_tpu.utils.metrics import reconstruction_psnr as j_reconstruction_psnr  # noqa: E402
import phenaki_tpu_torch.data.codecs as codecs
import phenaki_tpu_torch.data.datasets as datasets
import phenaki_tpu_torch.data.native as native
import phenaki_tpu_torch.utils.results_folder as rf
from phenaki_tpu_torch.bridge import load_cvivit_variables
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.training.checkpoint import CheckpointManager, load_pytree, save_pytree
from phenaki_tpu_torch.utils import (
    MetricLogger,
    accum_log,
    prepare_results_folder,
    profile_trace,
    psnr,
    reconstruction_psnr,
    save_image_grid,
)

torch.set_num_threads(1)

ROUTES = ["native", "pil"]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Both packages on one route: the native library, or PIL with the
    library hidden from both."""
    if request.param == "native":
        if not (native.available() and jnative.available()):
            pytest.fail("the native IO library did not load (native/libphenaki_io.so)")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


def _video(f=5, h=20, w=24, seed=0):
    return np.random.RandomState(seed).rand(f, h, w, 3).astype(np.float32)


@pytest.fixture
def gif_folder(tmp_path):
    d = tmp_path / "gifs"
    d.mkdir()
    for i, f in enumerate((5, 9, 7)):
        jcodecs.video_tensor_to_gif(_video(f=f, seed=i), str(d / f"v_{i}.gif"), optimize=False)
    return str(d)


@pytest.mark.parametrize("size,num_frames", [(16, 7), ((16, 12), 5)])
def test_video_dataset_gif_items_equal_jax(gif_folder, route, size, num_frames):
    ours = datasets.VideoDataset(gif_folder, size, num_frames=num_frames, horizontal_flip=False)
    ref = jdatasets.VideoDataset(gif_folder, size, num_frames=num_frames, horizontal_flip=False)
    assert ours.native_fast_path() == (route == "native") == ref._native_fast_path()
    assert len(ours) == len(ref) == 3
    for i in range(3):
        got = ours[i]
        assert got.dtype == np.float32 and got.shape == (num_frames, *datasets.pair(size), 3)
        np.testing.assert_array_equal(got, ref[i])


def test_video_dataset_mp4_items_equal_jax(tmp_path):
    for i in range(2):
        jcodecs.tensor_to_video((_video(f=6, h=32, w=40, seed=i) > 0.5).astype(np.float32),
                                str(tmp_path / f"m_{i}.mp4"))
    for frames, force in ((4, True), (9, True), (17, False)):
        ours = datasets.VideoDataset(str(tmp_path), 24, num_frames=frames, force_num_frames=force)
        ref = jdatasets.VideoDataset(str(tmp_path), 24, num_frames=frames, force_num_frames=force)
        for i in range(2):
            got = ours[i]
            assert got.shape[1:] == (24, 24, 3)
            np.testing.assert_array_equal(got, ref[i])


def test_image_dataset_items_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate(((20, 24), (31, 17), (16, 16))):
        img = Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))
        img.save(tmp_path / f"img_{i}.png")
    Image.fromarray((rng.rand(18, 22) * 255).astype(np.uint8)).save(tmp_path / "gray.png")
    for size in (16, (12, 16)):
        ours = datasets.ImageDataset(str(tmp_path), size, horizontal_flip=False)
        ref = jdatasets.ImageDataset(str(tmp_path), size, horizontal_flip=False)
        assert [p.name for p in ours.paths] == [p.name for p in ref.paths] and len(ours) == 4
        for i in range(4):
            got = ours[i]
            assert got.dtype == np.float32 and got.shape == (*datasets.pair(size), 3)
            np.testing.assert_array_equal(got, ref[i])


def test_cast_num_frames_collate_and_split_equal_jax():
    v = _video(f=5, h=8, w=8)
    for frames in (3, 5, 7):
        got = datasets.cast_num_frames(v, frames=frames)
        np.testing.assert_array_equal(got, jdatasets.cast_num_frames(v, frames=frames))
    assert datasets.cast_num_frames(v, frames=5) is v

    items = [(v, "a cat", np.int64(3) * np.ones(2, np.int64)), (v * 0.5, "a dog", np.ones(2, np.int64))]
    got, ref = datasets.collate_tensors_and_strings(items), jdatasets.collate_tensors_and_strings(items)
    assert len(got) == len(ref) == 3 and got[1] == ref[1] == ["a cat", "a dog"]
    for a, b in ((got[0], ref[0]), (got[2], ref[2])):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    (single,) = datasets.collate_tensors_and_strings([v, v])
    assert single.shape == (2, *v.shape)
    stacked = datasets.collate_tensors_and_strings([(torch.ones(2), "a"), (torch.zeros(2), "b")])
    assert torch.equal(stacked[0], torch.tensor([[1.0, 1.0], [0.0, 0.0]])) and stacked[1] == ["a", "b"]
    with pytest.raises(ValueError, match="invalid type"):
        datasets.collate_tensors_and_strings([(1.0,), (2.0,)])

    data = list(range(11))
    for frac, seed in ((0.34, 0), (0.2, 42)):
        train, valid = datasets.random_split(data, valid_frac=frac, seed=seed)
        jtrain, jvalid = jdatasets.random_split(data, valid_frac=frac, seed=seed)
        assert train.indices == jtrain.indices and valid.indices == jvalid.indices
        assert [train[i] for i in range(len(train))] == [jtrain[i] for i in range(len(jtrain))]


def test_dataloader_batches_and_cycle():
    data = [(np.full((2, 2), i, np.float32), f"t{i}") for i in range(7)]
    dl = datasets.DataLoader(data, batch_size=3, seed=5)
    batches = list(dl)
    assert len(dl) == len(batches) == 2  # the last partial batch dropped
    seen = sorted(int(b[0][j, 0, 0]) for b in batches for j in range(3))
    assert len(set(seen)) == 6 and all(isinstance(b[1], list) for b in batches)
    again = list(datasets.DataLoader(data, batch_size=3, seed=5))
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(batches, again))
    it = datasets.cycle(dl)
    assert len([next(it) for _ in range(5)]) == 5
    with pytest.raises(ValueError, match="empty"):
        datasets.DataLoader([], batch_size=2)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_repeat_runs_epoch_after_epoch(num_workers):
    """`repeat=True`: one iteration that does not end, each epoch a fresh
    permutation with its partial batch dropped; the same batches in the
    same order from worker processes as from the main process."""
    data = [(np.full((2, 2), i, np.float32), f"t{i}") for i in range(7)]
    it = iter(datasets.DataLoader(data, batch_size=3, seed=5, repeat=True, num_workers=num_workers))
    batches = [next(it) for _ in range(8)]
    epochs = [sorted(int(b[0][j, 0, 0]) for b in batches[e: e + 2] for j in range(3))
              for e in range(0, 8, 2)]
    assert all(len(set(e)) == 6 and set(e) <= set(range(7)) for e in epochs)
    assert len({tuple(e) for e in epochs}) > 1  # the dropped item changes between epochs
    assert all(b[1] == [f"t{int(v)}" for v in b[0][:, 0, 0]] for b in batches)
    inline = iter(datasets.DataLoader(data, batch_size=3, seed=5, repeat=True))
    assert all(np.array_equal(b[0], next(inline)[0]) for b in batches)
    with pytest.raises(ValueError, match="no batch"):
        datasets.DataLoader(data[:2], batch_size=3, repeat=True)


@pytest.mark.parametrize("optimize", [True, False])
def test_gifs_written_by_both_packages_are_byte_equal(tmp_path, route, optimize):
    video = _video(f=4, h=16, w=20, seed=7) * 1.2 - 0.1  # values outside [0, 1] are clipped
    ours, ref = tmp_path / "ours.gif", tmp_path / "ref.gif"
    codecs.video_tensor_to_gif(torch.from_numpy(video), str(ours), optimize=optimize)
    jcodecs.video_tensor_to_gif(video, str(ref), optimize=optimize)
    assert ours.read_bytes() == ref.read_bytes()
    got = codecs.gif_to_tensor(str(ours))
    assert got.shape == (4, 16, 20, 3)
    np.testing.assert_array_equal(got, jcodecs.gif_to_tensor(str(ref)))
    gray = (_video(f=3, h=8, w=8, seed=8)[..., :1])  # one channel: PIL in both packages
    codecs.video_tensor_to_gif(gray, str(tmp_path / "g.gif"))
    jcodecs.video_tensor_to_gif(gray, str(tmp_path / "jg.gif"))
    assert (tmp_path / "g.gif").read_bytes() == (tmp_path / "jg.gif").read_bytes()
    np.testing.assert_array_equal(codecs.gif_to_tensor(str(tmp_path / "g.gif"), channels=1),
                                  jcodecs.gif_to_tensor(str(tmp_path / "g.gif"), channels=1))


def test_mp4_codec_and_crop_equal_jax(tmp_path):
    video = (_video(f=6, h=32, w=32, seed=9) > 0.5).astype(np.float32)
    codecs.tensor_to_video(video, str(tmp_path / "ours.mp4"))
    jcodecs.tensor_to_video(video, str(tmp_path / "ref.mp4"))
    for name in ("ours.mp4", "ref.mp4"):
        path = str(tmp_path / name)
        for kw in ({}, {"num_frames": 3}, {"crop_size": (16, 24)}, {"crop_size": 8}):
            np.testing.assert_array_equal(codecs.video_to_tensor(path, **kw),
                                          jcodecs.video_to_tensor(path, **kw))
    img = np.arange(9 * 7 * 3).reshape(9, 7, 3)
    for cx, cy in ((4, 4), (7, 3), (10, 12)):
        np.testing.assert_array_equal(codecs.crop_center(img, cx, cy), jcodecs.crop_center(img, cx, cy))
    with pytest.raises(ValueError, match="no frames"):
        codecs.video_to_tensor(str(tmp_path / "missing.mp4"))


def test_native_binding_equals_jax(gif_folder):
    if not (native.available() and jnative.available()):
        pytest.fail("the native IO library did not load (native/libphenaki_io.so)")
    rng = np.random.RandomState(4)
    img = (rng.rand(21, 30, 3) * 255).astype(np.uint8)
    for kw in (dict(height=16, width=16), dict(height=12, width=20, hflip=True)):
        np.testing.assert_array_equal(native.transform_image(img, **kw), jnative.transform_image(img, **kw))
    paths = sorted(str(p) for p in Path(gif_folder).glob("*.gif"))
    paths.append(gif_folder + "/missing.gif")  # fails to decode: zeros
    flips = np.array([1, 0, 1, 0], np.uint8)
    got = native.load_gif_batch(paths, num_frames=6, height=16, width=12, hflip=flips)
    np.testing.assert_array_equal(got, jnative.load_gif_batch(paths, num_frames=6, height=16, width=12,
                                                              hflip=flips))
    assert not got[3].any() and got[:3].any()
    np.testing.assert_array_equal(native.gif_decode(paths[0]), jnative.gif_decode(paths[0]))
    with pytest.raises(ValueError, match="hflip"):
        native.load_gif_batch(paths, num_frames=6, height=16, width=12, hflip=flips[:2])
    with pytest.raises(ValueError, match="failed to parse"):
        native.gif_decode(paths[-1])


def test_save_image_grid_png_equals_jax(tmp_path):
    images = np.random.RandomState(5).rand(5, 8, 6, 3).astype(np.float32) * 1.4 - 0.2
    for nrow in (2, 3, 8):
        save_image_grid(torch.from_numpy(images), str(tmp_path / "ours.png"), nrow=nrow)
        j_save_image_grid(images, str(tmp_path / "ref.png"), nrow=nrow)
        assert (tmp_path / "ours.png").read_bytes() == (tmp_path / "ref.png").read_bytes()
    save_image_grid(images[..., :1], str(tmp_path / "g.png"), nrow=3)
    j_save_image_grid(images[..., :1], str(tmp_path / "jg.png"), nrow=3)
    assert (tmp_path / "g.png").read_bytes() == (tmp_path / "jg.png").read_bytes()


def test_psnr_equals_jax():
    rng = np.random.RandomState(6)
    target = rng.rand(3, 4, 8, 8, 3).astype(np.float32)
    pred = np.clip(target + rng.randn(*target.shape).astype(np.float32) * 0.05, 0, 1)
    pred[1] = target[1]  # a perfect match: the MSE floor
    for max_val in (1.0, 2.0):
        got = psnr(torch.from_numpy(pred), torch.from_numpy(target), max_val=max_val)
        np.testing.assert_allclose(got.item(), float(j_psnr(jnp.asarray(pred), jnp.asarray(target),
                                                            max_val=max_val)), rtol=1e-6)


def test_reconstruction_psnr_equals_jax():
    cfg = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
               spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
    jmod = JCViViT(**cfg, scan_layers=True)
    variables = jax.tree_util.tree_map(np.asarray, jit_init(jmod, jax.random.PRNGKey(0),
                                                            jnp.zeros((1, 3, 16, 16, 3))))
    mod = load_cvivit_variables(CViViT(**cfg), variables).train()
    videos = np.random.RandomState(7).rand(2, 5, 16, 16, 3).astype(np.float32)
    got = reconstruction_psnr(mod, torch.from_numpy(videos))
    assert mod.training  # the module's mode is restored
    ref = j_reconstruction_psnr(jmod, variables, jnp.asarray(videos))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def _seed_folder(tmp_path):
    folder = tmp_path / "results"
    folder.mkdir()
    (folder / "old_checkpoint.bin").write_bytes(b"x" * 16)
    return folder


@pytest.mark.parametrize("case", ["default_non_interactive", "clear_true", "clear_false", "missing",
                                  "interactive_yes", "interactive_no"])
def test_prepare_results_folder(tmp_path, monkeypatch, case):
    """The cases of tests/test_results_folder.py, on the port's guard."""
    if case == "missing":
        assert prepare_results_folder(tmp_path / "brand_new" / "nested").is_dir()
        return
    folder = _seed_folder(tmp_path)
    kw = {}
    if case.startswith("interactive"):
        monkeypatch.setattr(rf.sys.stdin, "isatty", lambda: True, raising=False)
        monkeypatch.setattr("builtins.input", lambda _: "y" if case.endswith("yes") else "n")
    elif case != "default_non_interactive":
        kw["clear_previous"] = case == "clear_true"
    out = prepare_results_folder(folder, **kw)
    assert out == folder and out.is_dir()
    cleared = case in ("clear_true", "interactive_yes")
    assert (folder / "old_checkpoint.bin").exists() != cleared


def test_metric_logger_accum_log_and_profile_trace(tmp_path):
    log = accum_log({"loss": 1.0}, {"loss": 0.5, "aux": 2.0})
    assert log == {"loss": 1.5, "aux": 2.0}
    MetricLogger().log(1, {"loss": torch.tensor(1.0)})  # no sink: nothing happens
    logger = MetricLogger(str(tmp_path / "logs" / "metrics.jsonl"))
    logger.log(1, {"loss": torch.tensor(0.25)})
    logger.log(2, {"loss": 0.125})
    lines = [json.loads(x) for x in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in lines] == [(1, 0.25), (2, 0.125)] and lines[0]["t"] >= 0
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    (trace,) = (tmp_path / "trace").glob("*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_checkpoint_manager(tmp_path, monkeypatch):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 3, "gen": torch.Generator().get_state(),
            "list": [torch.ones(2, dtype=torch.bfloat16), (1, 2.5)]}
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.latest_step is None and mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (0, 5, 10):
        tree["step"] = step
        mgr.save(step, tree)
    mgr.wait()
    assert mgr.all_steps() == [5, 10] and mgr.latest_step == 10
    got = mgr.restore()
    assert got["step"] == 10 and torch.equal(got["params"]["w"], tree["params"]["w"])
    assert torch.equal(got["gen"], tree["gen"]) and got["list"][1] == (1, 2.5)
    assert mgr.restore(5)["step"] == 5
    meta = mgr.metadata()
    assert meta["params"]["w"].device.type == "meta" and meta["params"]["w"].shape == (2, 3)
    assert meta["list"][0].dtype == torch.bfloat16 and meta["step"] == 10

    def broken_save(obj, f):
        open(f, "wb").write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(10, {"step": 11})
    monkeypatch.undo()
    assert mgr.restore(10)["step"] == 10  # the previous file is whole
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["10.pt", "5.pt"]
    mgr.close()
    save_pytree(tmp_path / "one.pt", {"a": torch.zeros(1)})
    assert torch.equal(load_pytree(tmp_path / "one.pt")["a"], torch.zeros(1))
