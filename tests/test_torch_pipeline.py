"""The port's serving pipeline (`of_dis_tpu_torch.pipeline`) on the CPU
against the JAX package's (`of_dis_tpu.pipeline`), run on the same frame
directories: the cases of tests/test_pipeline_stream.py. Files are held
at the port's `dis_flow_batched` budget against JAX's (EPE ratio <= 1e-3,
names and counts equal); the frames move by subpixel steps, since whole-
pixel motion at full resolution is chaotic between the two (ROADMAP
Queue 3). Each JAX pipeline runs once for the module."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from of_dis_tpu import pipeline as jax_pipeline
from of_dis_tpu_torch import pipeline
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.native import io as nio
from of_dis_tpu_torch.ops import pyramid
from of_dis_tpu_torch.parallel import mesh as pmesh
from of_dis_tpu_torch.params import op_point_params, pad_amounts
from of_dis_tpu_torch.utils import io as uio
from of_dis_tpu_torch.utils import viz

H, W = 96, 128
EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes run one torch thread: under several test workers a
    full pool of spinning threads per worker makes these many small
    operations tens of times slower, and starves the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_shift_frames(frame_dir, n_frames, dx, dy, h=H, w=W, seed=0):
    """Frames whose content translates by (dx, dy) px per step, written by
    the port's PNG writer (rows in every filter)."""
    os.makedirs(frame_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180)) * 255).astype(np.float32),
                           (9, 9), 2.5)
    for t in range(n_frames):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        f = cv2.warpAffine(big, m, (180, 140))[20:20 + h, 20:20 + w]
        viz.write_png(os.path.join(frame_dir, f"frame_{t:04d}.png"),
                      np.clip(f, 0, 255).astype(np.uint8))
    return str(frame_dir)


def _read(path):
    return uio.read_pfm(path)[..., None] if path.endswith(".pfm") \
        else uio.read_flo(path)


def _epe_ratio(ours, ref):
    return float(np.linalg.norm(ours - ref, axis=-1).mean()
                 / max(np.linalg.norm(ref, axis=-1).mean(), 1e-12))


def assert_files_match_jax(ours_dir, jax_dir):
    names = sorted(os.listdir(ours_dir))
    assert names == sorted(os.listdir(jax_dir))
    for name in names:
        ours = _read(os.path.join(ours_dir, name))
        ref = _read(os.path.join(jax_dir, name))
        assert ours.shape == ref.shape, name
        assert _epe_ratio(ours, ref) <= EPE_RATIO, name
    return names


def assert_same_bytes(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Frame directories and the JAX package's pipeline outputs on them."""
    root = tmp_path_factory.mktemp("pipeline")
    out = {"flow": write_shift_frames(root / "flow", 5, 1.5, 0.5),
           "depth": write_shift_frames(root / "depth", 4, -1.3, 0.0),
           "streams": write_shift_frames(root / "streams", 7, 1.5, 0.5),
           "root": root}
    for key, kw in (("flow", dict(op_point=1, batch=2)),
                    ("depth", dict(op_point=1, batch=2, mode="run_DE_INT")),
                    ("streams", dict(op_point=1, streams=2))):
        jax_out = str(root / f"jax_{key}")
        jax_pipeline.run_pipeline(out[key], jax_out, verbose=False, **kw)
        out[f"jax_{key}"] = jax_out
    return out


def test_cold_batches_with_ragged_tail(runs, tmp_path):
    """batch=2 with 4 pairs: two full batches; then batch=3: a ragged tail
    of one pair padded by repetition (its repeats not written)."""
    for batch in (2, 3):
        out = str(tmp_path / f"out{batch}")
        n = pipeline.run_pipeline(runs["flow"], out, op_point=1, batch=batch,
                                  verbose=False, device="cpu")
        assert n == 4
        names = assert_files_match_jax(out, runs["jax_flow"])
        assert names == [f"frame_{t:04d}.flo" for t in range(4)]
        for name in names:
            fl = uio.read_flo(os.path.join(out, name))
            assert fl.shape == (H, W, 2)
            med = np.median(fl[16:-16, 16:-16].reshape(-1, 2), axis=0)
            assert abs(med[0] - 1.5) < 0.4 and abs(med[1] - 0.5) < 0.4
    assert_same_bytes(str(tmp_path / "out2"), str(tmp_path / "out3"))


def test_depth_mode(runs, tmp_path):
    """run_DE_INT: consecutive frames as stereo pairs, .pfm outputs
    (run_dense.cpp:421); disparity <= 0, so the content moves by -1.3 px
    a frame."""
    out = str(tmp_path / "out")
    n = pipeline.run_pipeline(runs["depth"], out, op_point=1, batch=2,
                              mode="run_DE_INT", verbose=False, device="cpu")
    assert n == 3
    names = assert_files_match_jax(out, runs["jax_depth"])
    assert names == [f"frame_{t:04d}.pfm" for t in range(3)]
    for name in names:
        d = uio.read_pfm(os.path.join(out, name))
        assert d.shape == (H, W)
        assert abs(np.median(d[16:-16, 16:-16]) + 1.3) < 0.4


def test_warm_streams(runs, tmp_path):
    """--streams 2: the JAX package's streams output, and per-pair
    warm-start chaining (dis_flow_full + warm_start_from_full over each
    contiguous segment) at 1e-4 px, as the JAX test holds its own."""
    out = str(tmp_path / "out")
    n = pipeline.run_pipeline(runs["streams"], out, op_point=1, streams=2,
                              verbose=False, device="cpu")
    assert n == 6
    names = assert_files_match_jax(out, runs["jax_streams"])
    assert names == [f"frame_{t:04d}.flo" for t in range(6)]

    params = op_point_params(W, 1, nop=2, noc=1, verbosity=0)
    top, bot, left, right = pad_amounts(W, H, params.sc_f)
    fh, fw = H + top + bot, W + left + right
    frames = pipeline.list_frames(runs["streams"])
    pairs = list(zip(frames[:-1], frames[1:]))
    for seg in (pairs[:3], pairs[3:]):
        carry = dis.warm_carry_init(1, params, fw, fh, device="cpu")[0]
        for f1, f2 in seg:
            a, b = (pyramid.pad_to_divisible(
                torch.as_tensor(nio.decode_batch([f], 1)[0]), params.sc_f)
                for f in (f1, f2))
            full = dis.dis_flow_full(a, b, params, fw, fh, init_flow=carry,
                                     device="cpu")
            carry = dis.warm_start_from_full(full, params.sc_f)
            want = full[top:top + H, left:left + W].numpy()
            name = os.path.splitext(os.path.basename(f1))[0] + ".flo"
            got = uio.read_flo(os.path.join(out, name))
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                       err_msg=name)


def test_mesh_equals_one_device(runs, tmp_path):
    """The frame-pair axis split over 8 CPU devices writes the files one
    device writes, byte for byte: cold (one pair a device, the batch
    rounded up from 6 to 8) and warm streams (3 lanes rounded up to 4 over
    a mesh of 2, against 4 lanes on one device)."""
    root = tmp_path
    single, split = str(root / "single"), str(root / "split")
    n1 = pipeline.run_pipeline(runs["streams"], single, op_point=1, batch=8,
                               verbose=False, device="cpu")
    n2 = pipeline.run_pipeline(runs["streams"], split, op_point=1, batch=6,
                               mesh=pmesh.make_mesh(["cpu"] * 8),
                               verbose=False)
    assert n1 == n2 == 6
    assert_same_bytes(single, split)
    s_single, s_split = str(root / "s_single"), str(root / "s_split")
    pipeline.run_pipeline(runs["streams"], s_single, op_point=1, streams=4,
                          verbose=False, device="cpu")
    pipeline.run_pipeline(runs["streams"], s_split, op_point=1, streams=3,
                          mesh=pmesh.make_mesh(["cpu"] * 2), verbose=False)
    assert_same_bytes(s_single, s_split)


def test_decode_shards_follow_the_mesh_split(runs):
    """The pipeline cuts a step by `parallel.mesh.shard_bounds`, the rule
    `shard_batch` follows: shard d holds the frames of pairs
    bounds[d], each distinct frame decoded once."""
    frames = pipeline.list_frames(runs["streams"])
    pairs = list(zip(frames[:-1], frames[1:]))
    mesh = pmesh.make_mesh(["cpu"] * 3)
    step = pipeline._Step(pairs, [])
    shards = pipeline._decode_shards(step, mesh, (1, H, W), False, None)
    whole = torch.as_tensor(nio.decode_batch(frames, 1))
    bounds = pmesh.shard_bounds(mesh, len(pairs))
    assert [s.stop - s.start for s in bounds] == [2, 2, 2]
    for shard, s in zip(shards, bounds):
        assert shard.frames.shape[0] == 3      # 2 pairs share a frame
        first = s.start
        assert torch.equal(shard.frames[shard.ia], whole[first:s.stop])
        assert torch.equal(shard.frames[shard.ib],
                           whole[first + 1:s.stop + 1])
    with pytest.raises(ValueError, match="does not divide"):
        pipeline._decode_shards(pipeline._Step(pairs[:5], []), mesh,
                                (1, H, W), False, None)


def test_mesh_count_takes_the_first_cuda_devices(monkeypatch):
    """--mesh N on CUDA takes the first N devices and refuses more than
    there are; only --device cpu repeats its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = pipeline._mesh_from_spec("2", "cuda")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="only 2 CUDA devices"):
        pipeline._mesh_from_spec("3", "cuda")
    assert pipeline._mesh_from_spec("3", "cpu").devices == \
        (torch.device("cpu"),) * 3


def test_corrupt_frame_fails_the_run(tmp_path):
    """A truncated frame fails the run with a clear error, not a hang: the
    producer thread hands its exception through the queue."""
    frame_dir = str(tmp_path / "frames")
    write_shift_frames(frame_dir, 5, 1.5, 0.5)
    p = os.path.join(frame_dir, "frame_0003.png")
    with open(p, "rb") as f:
        raw = f.read()
    with open(p, "wb") as f:
        f.write(raw[:20])
    with pytest.raises(RuntimeError, match="frame decode failed") as e:
        pipeline.run_pipeline(frame_dir, str(tmp_path / "out"), op_point=1,
                              batch=2, verbose=False, device="cpu")
    assert isinstance(e.value.__cause__, ValueError)


def test_jpeg_frames_are_refused(tmp_path):
    """No longer refused: the directory of this test with a real JPEG frame
    (the next frame of the sequence, written by cv2) runs, both pairs, and
    its files meet the JAX pipeline's on the same directory."""
    frame_dir = str(tmp_path / "frames")
    write_shift_frames(frame_dir, 3, 1.5, 0.5)
    third = os.path.join(frame_dir, "frame_0002.png")
    img = uio.load_image(third, 1)[0].astype(np.uint8)
    os.remove(third)
    cv2.imwrite(os.path.join(frame_dir, "frame_0002.jpg"), img,
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    out, jax_out = str(tmp_path / "out"), str(tmp_path / "jax")
    n = pipeline.run_pipeline(frame_dir, out, op_point=1, batch=2,
                              verbose=False, device="cpu")
    assert n == 2
    jax_pipeline.run_pipeline(frame_dir, jax_out, op_point=1, batch=2,
                              verbose=False)
    assert assert_files_match_jax(out, jax_out) == [
        "frame_0000.flo", "frame_0001.flo"]


@pytest.mark.parametrize("op,mesh", [(1, 1), (3, 1), (4, 1), (3, 2)])
def test_default_batch_resolution(tmp_path, monkeypatch, op, mesh):
    """batch=0 resolves to the port's table (`pipeline.DEFAULT_BATCH`, per
    device), times the mesh size: the batch the pipeline hands
    dis_flow_batched, checked with a stand-in that returns zeros."""
    frame_dir = str(tmp_path / "frames")
    write_shift_frames(frame_dir, 3, 1.5, 0.5, h=64, w=96)
    seen = []

    def spy(a, b, params, full_w, full_h, device="cuda"):
        seen.append(int(a.shape[0]))
        return torch.zeros((a.shape[0], full_h, full_w, params.nop))

    monkeypatch.setattr(dis, "dis_flow_batched", spy)
    kw = dict(mesh=pmesh.make_mesh(["cpu"] * mesh)) if mesh > 1 \
        else dict(device="cpu")
    n = pipeline.run_pipeline(frame_dir, str(tmp_path / "out"), op_point=op,
                              batch=0, verbose=False, **kw)
    assert n == 2
    assert seen == [pipeline.DEFAULT_BATCH[op]] * mesh


def test_cuda_by_default_and_the_command_line(tmp_path, monkeypatch):
    frame_dir = write_shift_frames(str(tmp_path / "frames"), 3, 1.5, 0.5)
    out = str(tmp_path / "out")
    assert pipeline.main([frame_dir, out, "--op", "1", "--batch", "2",
                          "--mesh", "2", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["frame_0000.flo", "frame_0001.flo"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.run_pipeline(frame_dir, out, op_point=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.main([frame_dir, out, "--op", "1", "--mesh", "all"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.main([frame_dir, out, "--op", "1"])


def test_bench_frames_move_by_the_step(tmp_path):
    """`tools.bench_pipeline`'s frames (those of `chip_smoke.py`'s pipeline
    phase): content moving by the step, exactly at whole-pixel steps, and
    written as PNGs that decode to the same frames."""
    from of_dis_tpu_torch.tools import bench_pipeline
    fr = bench_pipeline.frame_stack(4, (2.0, 1.0), device="cpu", h=40, w=64)
    assert fr.shape == (4, 40, 64) and fr.dtype == torch.uint8
    for t in range(3):
        assert torch.equal(fr[t + 1, 1:, 2:], fr[t, :-1, :-2])
    left = bench_pipeline.frame_stack(3, (-1.0, 0.0), device="cpu", h=40,
                                      w=64)
    assert torch.equal(left[1, :, :-1], left[0, :, 1:])
    frames = bench_pipeline.make_frames(str(tmp_path / "f"), 3,
                                        device="cpu")
    paths = pipeline.list_frames(str(tmp_path / "f"))
    assert len(paths) == 3 and frames.shape == (3, 436, 1024)
    np.testing.assert_array_equal(nio.decode_batch(paths, 1)[:, 0], frames)
