"""The port's offline face tools against ``cv2`` and the JAX package, on the
CPU.

- ``preprocess/imgproc.py``: the rotation matrix, its inverse and the
  replicated-border warp bit-equal to cv2 on seeded grey regions; the
  TM_CCOEFF_NORMED map within 1e-5 of cv2's on textured templates, with
  the same arg-max, and its correlation the exact integer sum.
- ``preprocess/faces.py``: ``_iou``, ``_interpolate_gaps``, ``detect_near``
  and ``track_near`` against JAX's on the frames of
  ``tests/test_faces.py``'s tracker cases; ``extract_video_bboxes`` on
  mp4s written with cv2 (clean, tilted, occluded, one isolated detection):
  the same rows (boxes within 1e-3 px, scores within 1e-4) and ``.txt``
  files byte-equal but for a tracked row's 4-decimal score, which may sit
  one step apart (:func:`assert_txt_equal`); ``crop_face_frames`` against JAX's ``crop_resize_batch``
  on the same boxes.
- ``scripts/score_detector.py``: ``score_video`` against JAX's on two
  robustness cells built by JAX's builder at 20 frames.
- ``train.cli``: ``--raw_videos`` without ``--raw_audio`` fails with JAX's
  error.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mmer_tpu.ops.image import crop_resize_batch as jax_crop_resize_batch
from mmer_tpu.preprocess import faces as jax_faces
from mmer_tpu_torch.preprocess import faces as port_faces
from mmer_tpu_torch.preprocess import imgproc
from mmer_tpu_torch.preprocess.video import iter_video_frames
from mmer_tpu_torch.scripts import full_chain

from torch_threads import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grace_hopper() -> np.ndarray:
    pytest.importorskip("matplotlib")
    from matplotlib import cbook
    from PIL import Image

    return np.asarray(Image.open(
        cbook.get_sample_data("grace_hopper.jpg", asfileobj=False)))


def _rows_equal(got, want):
    """Rows equal: frames exactly, boxes within 1e-3 px, scores within 1e-4."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:5], w[1:5], rtol=0, atol=1e-3)
        assert abs(g[5] - w[5]) <= 1e-4


def assert_txt_equal(got: str, want: str):
    """Two ``.txt`` bbox files equal byte for byte, but that the 4-decimal
    score of a row may differ by one step: a tracked row's score is
    cv2's float32 correlation for JAX and the exact one for the port, up to
    ~1.5e-6 apart, so the two can fall either side of a rounding step."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        if g == w:
            continue
        g_head, g_conf = g.rsplit(",", 1)
        w_head, w_conf = w.rsplit(",", 1)
        assert g_head == w_head, (g, w)
        assert abs(round((float(g_conf) - float(w_conf)) * 1e4)) == 1, (g, w)


def _hit_equal(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=1e-3)
        assert abs(got[4] - want[4]) <= 1e-4


# -- imgproc against cv2 ---------------------------------------------------------

@pytest.mark.parametrize("center, angle, scale", [
    ((60.0, 45.5), 15.0, 1.0), ((60.0, 45.5), -30.0, 1.0),
    ((33.3, 71.7), 123.4, 0.8), ((0.1, 0.2), -179.0, 1.7)])
def test_rotation_matrix_and_inverse_are_cv2s(center, angle, scale):
    m = cv2.getRotationMatrix2D(center, angle, scale)
    np.testing.assert_array_equal(imgproc.rotation_matrix_2d(center, angle, scale), m)
    np.testing.assert_array_equal(imgproc.invert_affine(m),
                                  cv2.invertAffineTransform(m))


@pytest.mark.parametrize("seed", range(6))
def test_warp_affine_is_bit_equal_to_cv2(seed):
    """Seeded grey regions of interest (uniform noise and smoothed), the
    tracker's four retry angles about the centre and a random affine map
    into another size; widths below, at and past the 16-pixel step."""
    rng = np.random.default_rng(seed)
    for h, w in ((7, 5), (24, 16), (31, 17), (150, 133), (270, 375)):
        gray = rng.integers(0, 256, (h, w), np.uint8)
        if seed % 2:
            gray = cv2.GaussianBlur(gray, (0, 0), 3)
        for angle in (15.0, -15.0, 30.0, -30.0):
            m = imgproc.rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
            np.testing.assert_array_equal(
                imgproc.warp_affine(gray, m, (w, h)),
                cv2.warpAffine(gray, m, (w, h), borderMode=cv2.BORDER_REPLICATE))
        m = cv2.getRotationMatrix2D((float(rng.uniform(0, w)),
                                     float(rng.uniform(0, h))),
                                    float(rng.uniform(-180, 180)),
                                    float(rng.uniform(0.5, 1.5)))
        size = (int(rng.integers(5, 200)), int(rng.integers(5, 200)))
        np.testing.assert_array_equal(
            imgproc.warp_affine(gray, m, size),
            cv2.warpAffine(gray, m, size, borderMode=cv2.BORDER_REPLICATE))


@pytest.mark.parametrize("seed", range(4))
def test_match_template_matches_cv2(seed):
    """Face regions: a patch of the face (and its four halves, as
    ``track_near`` cuts them) against a noisy, shifted copy of the frame."""
    rng = np.random.default_rng(seed)
    face = cv2.cvtColor(np.load(full_chain.ASSET), cv2.COLOR_RGB2GRAY)
    y, x = int(rng.integers(20, 80)), int(rng.integers(20, 80))
    templ = face[y:y + 110, x:x + 96].copy()
    image = np.clip(face.astype(int) + rng.integers(-12, 12, face.shape),
                    0, 255).astype(np.uint8)
    th, tw = templ.shape
    matcher = imgproc.TemplateMatcher(image)
    for part in (templ, templ[:th // 2], templ[th - th // 2:],
                 templ[:, :tw // 2], templ[:, tw - tw // 2:]):
        want = cv2.matchTemplate(image, part, cv2.TM_CCOEFF_NORMED)
        got = matcher.scores(part)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        _, score, _, loc = cv2.minMaxLoc(want)
        got_score, got_loc = matcher.best(part)
        assert got_loc == loc
        assert abs(got_score - score) <= 1e-5
    assert imgproc.match_template_best(image, templ)[1] == matcher.best(templ)[1]


def test_template_correlation_is_the_exact_integer_sum():
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (41, 37), np.uint8)
    templ = rng.integers(0, 256, (17, 12), np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(image.astype(np.int64), (17, 12))
    direct = np.einsum("ijuv,uv->ij", win, templ.astype(np.int64))
    got = imgproc.TemplateMatcher(image)._cross_correlation(templ)
    np.testing.assert_array_equal(got, direct.astype(np.float64))
    flat = np.full((17, 12), 9, np.uint8)
    np.testing.assert_array_equal(imgproc.match_template_ccoeff_normed(image, flat),
                                  cv2.matchTemplate(image, flat, cv2.TM_CCOEFF_NORMED))


# -- the tracker's pieces against JAX's -------------------------------------------

def test_iou_and_interpolate_gaps_match_jax():
    boxes = [(0, 0, 10, 10), (5, 5, 15, 15), (20, 20, 30, 40), (0, 0, 0, 0),
             (2.5, 1.25, 7.75, 9.5)]
    for a in boxes:
        for b in boxes:
            assert port_faces._iou(a, b) == jax_faces._iou(a, b)
    rows = [(0, 10.0, 20.0, 110.0, 130.0, 0.9), (0, 12.0, 22.0, 100.0, 120.0, 0.95),
            (4, 30.0, 40.0, 130.0, 150.0, 0.7), (7, 33.5, 41.25, 131.0, 152.0, 0.8),
            (30, 0.0, 0.0, 50.0, 50.0, 0.6)]
    anchors = [0, 4, 7, 30]
    for gap in (1, 3, 10, 40):
        assert (port_faces._interpolate_gaps(rows, anchors, gap)
                == jax_faces._interpolate_gaps(rows, anchors, gap))


def _occlusion_frames():
    """tests/test_faces.py:test_track_near_holds_through_partial_occlusion's
    frames: the portrait at 96x112 on noise, 40 % and fully covered, and
    far from the prior."""
    face = cv2.resize(_grace_hopper(), (96, 112))
    rng = np.random.default_rng(0)

    def frame_with_face(ox, oy, cover_frac=0.0):
        f = np.clip(rng.normal(110, 12, (360, 480, 3)), 0, 255)
        f[oy:oy + 112, ox:ox + 96] = face
        if cover_frac:
            y1 = oy + int(112 * (1 - cover_frac))
            cv2.rectangle(f, (ox - 4, y1), (ox + 100, oy + 116), (70, 70, 70), -1)
        return f.astype(np.uint8)

    template = cv2.cvtColor(face, cv2.COLOR_RGB2GRAY)
    return (template, [frame_with_face(212, 128, 0.40), frame_with_face(212, 128, 1.0),
                       frame_with_face(20, 20, 0.0), frame_with_face(205, 124, 0.25)])


def test_track_near_matches_jax():
    template, frames = _occlusion_frames()
    prior = (200.0, 120.0, 296.0, 232.0)
    port, jax = port_faces.HaarFaceDetector(), jax_faces.HaarFaceDetector()
    hits = 0
    for frame in frames:
        got = port.track_near(frame, prior, template)
        _hit_equal(got, jax.track_near(frame, prior, template))
        hits += got is not None
    assert hits >= 2           # the 40 % and 25 % cover frames are tracked


def _tilted_frame(angle: float) -> np.ndarray:
    """The portrait at 300x256 rotated in-plane on a noisy 360x480 frame."""
    face = cv2.resize(_grace_hopper(), (256, 300))
    rng = np.random.default_rng(1)
    frame = np.clip(rng.normal(110, 12, (360, 480, 3)), 0, 255).astype(np.uint8)
    m = cv2.getRotationMatrix2D((128, 150), angle, 1.0)
    frame[30:330, 100:356] = cv2.warpAffine(face, m, (256, 300),
                                            borderMode=cv2.BORDER_REPLICATE)
    return frame


@pytest.mark.parametrize("angle", [0.0, 20.0, -30.0, 35.0])
def test_detect_near_matches_jax(angle):
    """An upright and tilted faces: the relaxed pass, the rotated retries and
    a miss, each with the prior the upright face's detection gives."""
    port, jax = port_faces.HaarFaceDetector(), jax_faces.HaarFaceDetector()
    upright = _tilted_frame(0.0)
    x1, y1, x2, y2, _ = port.detect(upright)[0]
    frame = _tilted_frame(angle)
    for prior in ((x1, y1, x2, y2), (x1 + 9.0, y1 - 6.0, x2 + 9.0, y2 - 6.0),
                  (0.0, 0.0, 60.0, 60.0)):
        _hit_equal(port.detect_near(frame, prior), jax.detect_near(frame, prior))


# -- extract_video_bboxes on mp4s -----------------------------------------------

def _write_mp4(path, frames):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (frames.shape[2], frames.shape[1]))
    if not w.isOpened():
        pytest.skip("no mp4 encoder")
    for f in frames:
        w.write(np.ascontiguousarray(f[:, :, ::-1]))
    w.release()


def _clip(kind: str) -> np.ndarray:
    face = full_chain.packaged_face()
    rng = np.random.default_rng(7)
    if kind == "clean":
        return full_chain.raw_clip_frames(face, rng, 20)
    if kind == "tilted":
        return full_chain.raw_clip_frames(face, rng, 24, tilt=(30.0, 6, 18))
    if kind == "occluded":
        return full_chain.raw_clip_frames(face, rng, 24, occlusion=(0.4, 6, 18))
    # One frame with the face, the rest noise (tests/test_faces.py's
    # track-birth hysteresis case).
    img = np.load(full_chain.ASSET)
    frames = np.clip(rng.normal(110, 12, (12,) + img.shape), 0, 255).astype(np.uint8)
    frames[5] = np.clip(img.astype(np.int16) + rng.integers(-8, 8, img.shape),
                        0, 255).astype(np.uint8)
    return frames


@pytest.mark.parametrize("kind", ["clean", "tilted", "occluded", "isolated"])
def test_extract_video_bboxes_matches_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.mp4")
    _write_mp4(path, _clip(kind))
    stats = port_faces.TrackStats()
    got = port_faces.extract_video_bboxes(path, stats=stats)
    want = jax_faces.extract_video_bboxes(path)
    _rows_equal(got, want)
    port_faces.write_bboxes_txt(str(tmp_path / "port.txt"), got)
    jax_faces.write_bboxes_txt(str(tmp_path / "jax.txt"), want)
    assert_txt_equal((tmp_path / "port.txt").read_text(),
                     (tmp_path / "jax.txt").read_text())
    assert port_faces.read_bboxes_txt(str(tmp_path / "port.txt")) == \
        jax_faces.read_bboxes_txt(str(tmp_path / "jax.txt"))
    assert stats.full + stats.relaxed + stats.tracked + stats.interpolated == len(got)
    if kind == "tilted":
        assert stats.relaxed > 0
    if kind == "occluded":
        assert stats.tracked > 0
    if kind == "isolated":
        assert {r[0] for r in got} <= {5}
    # The frame-taking core on the same decoded frames gives the same rows.
    assert port_faces.extract_frame_bboxes(list(iter_video_frames(path)[1])) == got


def test_crop_face_frames_matches_jax_crop():
    """The writer's boxes (best box, else the last, else the whole frame)
    and crops: against JAX's ``crop_resize_batch`` on the same boxes, f32
    within 1e-3 and the truncated uint8 crops at most 1 apart on under
    0.1 % of values (``tests/test_torch_serve.py``'s bound)."""
    import jax.numpy as jnp

    frames = _clip("occluded")[:10]
    rows = [(2, 150.0, 60.0, 260.0, 190.0, 0.9), (2, 10.0, 10.0, 50.0, 50.0, 0.5),
            (3, 151.5, 61.0, 262.0, 191.5, 0.8), (7, 148.0, 58.0, 258.0, 187.0, 0.7)]
    boxes, crops = zip(*port_faces.iter_face_crops(frames, rows, (224, 224),
                                                   batch=4, device="cpu"))
    boxes = np.concatenate(boxes)
    whole = [0.0, 0.0, 480.0, 360.0]
    want_boxes = [whole, whole, rows[0][1:5], rows[2][1:5], rows[2][1:5],
                  rows[2][1:5], rows[2][1:5], rows[3][1:5], rows[3][1:5], rows[3][1:5]]
    np.testing.assert_array_equal(boxes, np.asarray(want_boxes, np.float32))
    got = port_faces.crop_face_frames(frames, rows, (224, 224), batch=4,
                                      device="cpu").astype(int)
    np.testing.assert_array_equal(got, np.concatenate(crops))
    want = np.asarray(jax_crop_resize_batch(jnp.asarray(frames), jnp.asarray(boxes),
                                            out_hw=(224, 224)))
    q_want = np.clip(want, 0, 255).astype(np.uint8).astype(int)
    assert np.abs(got - q_want).max() <= 1
    assert float((got != q_want).mean()) < 1e-3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_faces.crop_face_frames(frames, rows, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            port_faces.convert_folder_faces(REPO, REPO, REPO, device="cuda")


# -- the scorer -------------------------------------------------------------------

@pytest.fixture(scope="module")
def robustness_cells(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "jax_score_detector", os.path.join(REPO, "scripts", "score_detector.py"))
    jax_scorer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_scorer)
    cells = jax_scorer.build_robustness_cells(str(tmp_path_factory.mktemp("cells")),
                                              frames=20)
    return jax_scorer, {cell: (path, gt) for cell, path, gt in cells}


@pytest.mark.parametrize("cell", ["rotation_30", "occlusion_40"])
def test_score_video_matches_jax(robustness_cells, cell):
    from mmer_tpu_torch.scripts import score_detector

    jax_scorer, cells = robustness_cells
    path, gt = cells[cell]
    got = score_detector.score_video(path, gt=gt)
    want = jax_scorer.score_video(path, gt=gt)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, abs=1e-9), key
        else:
            assert got[key] == value, key


def test_scorer_gt_parsing_and_iou(tmp_path):
    from mmer_tpu_torch.scripts.score_detector import iou, load_gt

    p = tmp_path / "v_bboxes.txt"
    p.write_text("0,10,20,110,120,0.97\n0,5,5,50,50,0.8\n2,0,0,10,10,0.9\n")
    gt = load_gt(str(p))
    assert set(gt) == {0, 2} and len(gt[0]) == 2
    np.testing.assert_allclose(gt[0][0], [10, 20, 110, 120])
    a = np.asarray([0, 0, 10, 10], float)
    assert iou(a, a) == pytest.approx(1.0)
    assert iou(a, np.asarray([20, 20, 30, 30], float)) == 0.0


# -- the training CLI's raw-media flags ---------------------------------------------

def test_train_cli_raw_videos_needs_raw_audio(capsys):
    from mmer_tpu_torch.train.cli import main

    with pytest.raises(SystemExit) as e:
        main(["--raw_videos", "somewhere", "--device", "cpu"])
    assert e.value.code == 2
    assert "--raw_videos and --raw_audio must be given together" in \
        capsys.readouterr().err
