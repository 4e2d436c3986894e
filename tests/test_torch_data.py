"""The port's data pipeline against the JAX package's: synthetic scenes,
the HAMMER index and loader (cv2) over a scene written to disk, the tracked
splits, the batch iterator's order, resume, cache and shards, and the
device prefetch."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from polardepth_tpu.data import hammer as jhammer  # noqa: E402
from polardepth_tpu.data import pipeline as jpipeline  # noqa: E402
from polardepth_tpu.data import synthetic as jsynthetic  # noqa: E402

from polardepth_tpu_torch.data import hammer, pipeline, synthetic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside the
    other test workers torch's default of a thread per core oversubscribes
    the machine, where its thread barriers stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("materials", [
    {}, {"degenerate_materials": ("glass", "cutlery")},
    {"transmissive_materials": ("glass",)},
    {"degenerate_materials": ("can",), "transmissive_materials": ("cup",)}])
def test_synthetic_scenes_bit_identical(materials):
    ours = synthetic.SyntheticHammer(H, W, seed=3, **materials)
    ref = jsynthetic.SyntheticHammer(H, W, seed=3, **materials)
    for index, frame in ((0, 0), (5, 10)):
        _equal(ours.sample(index, frame), ref.sample(index, frame))
    _equal(ours.batch_frames(2, (0, -1, 1), 10, start=1),
           ref.batch_frames(2, (0, -1, 1), 10, start=1))
    np.testing.assert_array_equal(ours.relative_pose(2, 10, 0),
                                  ref.relative_pose(2, 10, 0))


def test_synthetic_refuses_an_unknown_material():
    with pytest.raises(ValueError):
        synthetic.SyntheticHammer(H, W, degenerate_materials=("marble",))


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("hammer")
    synthetic.write_synthetic_scene(str(root), "scene_a", num_frames=24,
                                    height=H, width=W, seed=1,
                                    degenerate_materials=("glass",))
    jsynthetic.write_synthetic_scene(str(root), "scene_j", num_frames=24,
                                     height=H, width=W, seed=1,
                                     degenerate_materials=("glass",))
    return root


def test_written_scene_equals_the_jax_package_s(scene_root):
    a = scene_root / "scene_a" / "polarization"
    b = scene_root / "scene_j" / "polarization"
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) == 1 + 24 * 8
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("frame_ids", [(0,), (0, -1, 1)])
def test_hammer_loader_matches_jax_cv2(scene_root, frame_ids):
    ours = hammer.HammerIndex(str(scene_root), ["scene_a"], frame_ids, 10)
    ref = jhammer.HammerIndex(str(scene_root), ["scene_a"], frame_ids, 10)
    assert ours.entries == ref.entries
    assert len(ours) == (24 if frame_ids == (0,) else 4)
    lo, lj = hammer.HammerLoader(ours), jhammer.HammerLoader(ref,
                                                             backend="cv2")
    for i in (0, len(ours) - 1):
        for fid in frame_ids:
            _equal(lo.load(i, fid), lj.load(i, fid))
        base = ours.entries[i][0]
        np.testing.assert_array_equal(lo.intrinsics_for(base, 96, 64),
                                      lj.intrinsics_for(base, 96, 64))
        idx = ours.entries[i][1]
        np.testing.assert_array_equal(
            lo.relative_pose(base, (idx + 10) % 24, idx),
            lj.relative_pose(base, (idx + 10) % 24, idx))
    s = lo.load(0)
    assert s["color"].dtype == np.uint8 and s["pol"].shape == (H, W, 4)
    assert s["mask"].dtype == np.int32 and s["depth_gt"].dtype == np.float32


@pytest.mark.parametrize("backend", ["auto", "native", "pil"])
def test_hammer_loader_refuses_other_backends(scene_root, backend):
    index = hammer.HammerIndex(str(scene_root), ["scene_a"])
    with pytest.raises(ValueError, match="cv2"):
        hammer.HammerLoader(index, backend=backend)


def test_read_split_matches_jax_over_the_tracked_splits():
    splits = os.path.join(ROOT, "splits")
    seen = 0
    for split in sorted(os.listdir(splits)):
        for name in sorted(os.listdir(os.path.join(splits, split))):
            if not name.endswith("_files.txt"):
                continue
            part = name[:-len("_files.txt")]
            got = hammer.read_split(splits, split, part)
            assert got == jhammer.read_split(splits, split, part)
            assert got and all(s == s.strip() for s in got)
            seen += 1
    assert seen >= 3


def _iterators(cls, log=None, **kw):
    def load(i):
        if log is not None:
            log.append(int(i))
        return {"x": np.full((2, 3), i, np.int32), "name": f"s{i}"}
    return cls(load, 10, 3, shuffle=True, seed=7, num_workers=2, **kw)


def _drain(it):
    return [b["x"][:, 0, 0].tolist() for b in it]


def test_batch_iterator_order_and_resume_match_jax():
    ours = _iterators(pipeline.BatchIterator)
    ref = _iterators(jpipeline.BatchIterator)
    assert len(ours) == len(ref) == 3
    for _ in range(3):                       # three epochs, reshuffled
        a, b = _drain(iter(ours)), _drain(iter(ref))
        assert a == b and len(a) == 3
    assert ours.state() == ref.state() == {"seed": 7, "epoch": 3,
                                           "cursor": 0}
    # stop after one batch of epoch 3, snapshot, resume in a fresh iterator
    it = iter(ours)
    next(it)
    snap = ours.state()
    resumed = _iterators(pipeline.BatchIterator)
    resumed.set_state(snap)
    ref.set_state(snap)
    assert _drain(iter(resumed)) == _drain(iter(ref))
    assert _drain(iter(resumed)) == _drain(iter(ref))
    with pytest.raises(ValueError):
        resumed.set_state({"seed": 8, "epoch": 0, "cursor": 0})
    # only arrays are stacked
    assert set(next(iter(_iterators(pipeline.BatchIterator)))) == {"x"}


def test_batch_iterator_cache_and_shards_match_jax():
    log_o, log_j = [], []
    ours = _iterators(pipeline.BatchIterator, log_o, cache_bytes=1 << 20)
    ref = _iterators(jpipeline.BatchIterator, log_j, cache_bytes=1 << 20)
    for _ in range(2):
        assert _drain(iter(ours)) == _drain(iter(ref))
    assert sorted(log_o) == sorted(log_j) and len(set(log_o)) == len(log_o)
    tiny = _iterators(pipeline.BatchIterator, [], cache_bytes=48)
    _drain(iter(tiny))
    assert len(tiny._cache) == 2          # 24 bytes per sample
    for k in range(2):
        a = _iterators(pipeline.BatchIterator, shard_index=k, num_shards=3)
        b = _iterators(jpipeline.BatchIterator, shard_index=k, num_shards=3)
        assert _drain(iter(a)) == _drain(iter(b))
    with pytest.raises(ValueError):
        _iterators(pipeline.BatchIterator, num_shards=2)


def test_device_prefetch_delivers_tensors_on_the_cpu():
    ours = _iterators(pipeline.BatchIterator)
    batches = list(pipeline.device_prefetch(iter(ours), "cpu"))
    ref = list(iter(_iterators(pipeline.BatchIterator)))
    assert len(batches) == 3
    for got, want in zip(batches, ref):
        assert isinstance(got["x"], torch.Tensor)
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])


def test_device_prefetch_reraises_a_producer_error():
    def batches():
        yield {"x": np.zeros(3)}
        raise OSError("decode failed")

    it = pipeline.device_prefetch(batches(), "cpu")
    assert next(it)["x"].shape == (3,)
    with pytest.raises(OSError, match="decode failed"):
        next(it)
