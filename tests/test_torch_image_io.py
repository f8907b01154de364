"""The port's image files and resizing (``data/image_io.py``) against
OpenCV on seeded images: PNGs either one writes the other reads equal, every
PNG filter type read, ``resize`` to 1e-6 of ``cv2.resize``, Radiance files
that ``cv2.imread`` reads as it reads its own, and the refusal to write
JPEG or mp4 without OpenCV."""
import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from relightableavatar_tpu_torch.data import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIZE_ATOL = 1e-6
SHAPES = {"gray": (37, 53), "rgb": (37, 53, 3), "rgba": (37, 53, 4)}


def _seeded(shape, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 255).astype(np.uint8)
    img[:9] = 17                                    # a flat band: runs for zlib
    img[9:20] = np.arange(img.shape[1], dtype=np.uint8)[None, :, None][..., 0] \
        if img.ndim == 2 else np.arange(img.shape[1], dtype=np.uint8)[None, :, None]
    return img


def _to_cv2(img):
    """RGB(A) -> the BGR(A) order OpenCV takes."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]


@pytest.mark.parametrize("kind", SHAPES)
def test_reads_pngs_written_by_opencv(tmp_path, kind):
    img = _seeded(SHAPES[kind])
    for level in (0, 1, 9):                          # libpng picks other filters per level
        path = str(tmp_path / f"cv_{level}.png")
        cv2.imwrite(path, _to_cv2(img), [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(image_io.read_png(path), img)


@pytest.mark.parametrize("kind", SHAPES)
def test_opencv_reads_the_ports_pngs(tmp_path, kind):
    img = _seeded(SHAPES[kind], seed=1)
    path = str(tmp_path / "port.png")
    image_io.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, _to_cv2(img))
    np.testing.assert_array_equal(image_io.read_png(path), img)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_reads_every_filter_type(tmp_path, filt):
    """A PNG whose every row uses one filter type, encoded here by the
    specification's formulas, reads back to the image (and so does OpenCV)."""
    img = _seeded((23, 19, 3), seed=2).astype(np.int64)
    H, W, bpp = img.shape[0], img.shape[1] * 3, 3
    rows = img.reshape(H, W)
    out = []
    for y in range(H):
        prior = rows[y - 1] if y else np.zeros(W, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), rows[y, :-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if filt == 0:
            pred = np.zeros(W, np.int64)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(np.concatenate([[filt], (rows[y] - pred) % 256]))
    data = np.asarray(out, np.uint8).tobytes()
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        import struct
        chunk = lambda k, b: (struct.pack('>I', len(b)) + k + b
                              + struct.pack('>I', zlib.crc32(k + b) & 0xFFFFFFFF))
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', img.shape[1], H, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(data)) + chunk(b'IEND', b''))
    np.testing.assert_array_equal(image_io.read_png(path), img.astype(np.uint8))
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img.astype(np.uint8))


@pytest.mark.parametrize("kind", SHAPES)
def test_read_rgb_and_gray_match_opencv(tmp_path, kind):
    img = _seeded(SHAPES[kind], seed=3)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, _to_cv2(img))
    np.testing.assert_array_equal(image_io.read_rgb(path),
                                  cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))
    if kind == "gray":
        np.testing.assert_array_equal(image_io.read_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("interp,ratio", [
    (image_io.INTER_AREA, 0.5), (image_io.INTER_AREA, 0.25), (image_io.INTER_AREA, 0.3),
    (image_io.INTER_AREA, 3.2), (image_io.INTER_LINEAR, 0.5), (image_io.INTER_LINEAR, 0.25),
    (image_io.INTER_LINEAR, 0.7), (image_io.INTER_LINEAR, 1.6),
    (image_io.INTER_NEAREST, 0.5), (image_io.INTER_NEAREST, 0.25), (image_io.INTER_NEAREST, 0.7),
], ids=lambda v: str(v))
def test_resize_matches_opencv(interp, ratio, channels):
    """Ratios 0.5 and 0.25 are the ones under configs/; 3.2 is the
    visualizer's probe inset (16 x 32 texels to a fifth of the frame)."""
    rng = np.random.default_rng(4)
    img = rng.random((64, 48, channels)).astype(np.float32)
    if channels == 1:
        img = img[..., 0]
    dsize = (int(48 * ratio), int(64 * ratio))
    ref = cv2.resize(img, dsize, interpolation=interp)
    ours = image_io.resize(img, dsize, interp)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0, atol=RESIZE_ATOL)


def test_resize_nearest_keeps_masks_exact():
    rng = np.random.default_rng(5)
    msk = (rng.random((64, 48)) > 0.5).astype(np.uint8)
    for dsize in ((24, 32), (12, 16), (33, 45)):
        np.testing.assert_array_equal(image_io.resize(msk, dsize, image_io.INTER_NEAREST),
                                      cv2.resize(msk, dsize, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("width", [5, 40, 300], ids=["flat", "rle", "rle_many_dumps"])
def test_hdr_reads_back_as_opencvs_own(tmp_path, width):
    rng = np.random.default_rng(6)
    img = (rng.random((11, width, 3)) * 50).astype(np.float32)
    img[0, :3] = 0                                  # black texels: e = 0
    img[1, :2] = 1e-40
    ours, theirs = str(tmp_path / "p.hdr"), str(tmp_path / "c.hdr")
    image_io.write_hdr(ours, img)
    cv2.imwrite(theirs, img[..., ::-1])
    a = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    b = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, b)
    # one shared exponent a pixel, 8 bits a channel, truncated: within a
    # 128th of the pixel's largest channel
    bound = img.max(axis=-1, keepdims=True) / 128 + 1e-30
    assert np.all(np.abs(a[..., ::-1] - img) <= bound)


def test_needs_opencv_names_the_file_and_the_setting(tmp_path):
    """With cv2 blocked, JPEG and video raise, naming the file and the
    override; PNG still works."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from relightableavatar_tpu_torch.data import image_io\n"
        "from relightableavatar_tpu_torch.vis import visualizer\n"
        f"d = {str(tmp_path)!r}\n"
        "img = np.zeros((4, 4, 3), np.uint8)\n"
        "image_io.write_image(d + '/ok.png', img)\n"
        "for fn, arg, name, want in (\n"
        "        (image_io.write_image, (d + '/x.jpg', img), d + '/x.jpg', 'vis_ext .png'),\n"
        "        (visualizer.generate_video, (d, d + '/v.mp4'), d + '/v.mp4', 'store_video_output False'),\n"
        "        (image_io.read_rgb, (d + '/x.jpg',), d + '/x.jpg', 'PNG')):\n"
        "    try:\n"
        "        fn(*arg)\n"
        "    except image_io.NeedsOpenCV as e:\n"
        "        assert name in str(e) and want in str(e), str(e)\n"
        "    else:\n"
        "        raise AssertionError(f'{fn.__name__} did not raise')\n"
        "import os; assert os.listdir(d) == ['ok.png'], os.listdir(d)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
