#!/usr/bin/env python3
"""Write the image fixtures of the port's native reader and their manifest.

    python tests/torch_fixtures/images/make_images.py   # needs numpy and cv2

Every image is numpy from a fixed seed, written by cv2 with the options the
data sets' own files come with: 640x480 frames as JPEG (4:2:0 at quality 95,
4:4:4 at quality 75 with a restart interval, 4:2:2 at 641x479 off the MCU
grid, a grey 320x240), HO3D-style masks as PNG at 320x240 and 640x480 with
one and three channels, and a 512x512 object texture_map.png. The PNGs
are written with an explicit compression level: cv2 then leaves libpng's
adaptive filtering on, which picks all five scanline filters here (soft
edges, smooth waves); without one, cv2 writes every line with Sub.
manifest.json holds, per file, the SHA-256 of its bytes and of the array
cv2.imread gives (C order), that array's shape and the PNG filter types
used; per resize of the data path (a mask to 640x480, the texture to the
surface tables' 256), the SHA-256 of cv2.resize's array; and the versions
of cv2, libjpeg-turbo and libpng that made them. tests/test_torch_images.py
and chip_smoke.py hold the port's reader to it.
"""

from __future__ import annotations

import hashlib
import json
import re
import zlib
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 14

JPEGS = {
    # name: (height, width, channels, cv2 options)
    "frame_420_q95.jpg": (480, 640, 3, [cv2.IMWRITE_JPEG_QUALITY, 95,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "frame_444_q75_rst.jpg": (480, 640, 3, [cv2.IMWRITE_JPEG_QUALITY, 75,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                                            cv2.IMWRITE_JPEG_RST_INTERVAL, 7]),
    "frame_422_641x479.jpg": (479, 641, 3, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "grey_320x240.jpg": (240, 320, 1, [cv2.IMWRITE_JPEG_QUALITY, 90]),
}
MASKS = {f"mask_{w}x{h}_{c}ch.png": (h, w, c) for h, w in ((240, 320), (480, 640)) for c in (1, 3)}
TEXTURE = "texture_map.png"
# the data path's resizes: (source, (width, height))
RESIZES = [(name, (640, 480)) for name in MASKS] + [(TEXTURE, (256, 256))]


def smooth_image(rng, h: int, w: int, c: int, noise: float) -> np.ndarray:
    """Sums of random low-frequency waves per channel, plus Gaussian noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, c))
    for k in range(c):
        for _ in range(3):
            fx, fy = rng.uniform(0.002, 0.04, 2)
            img[..., k] += 40 * np.sin(fx * xx + rng.uniform(0, 6)) * np.cos(fy * yy + rng.uniform(0, 6))
    img += 128 + rng.randn(h, w, c) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


def mask_image(rng, h: int, w: int, c: int) -> np.ndarray:
    """A hand-and-object style label mask: two ellipses with blurred edges,
    one per channel of a three-channel mask (the other channel empty), both
    in the one channel of a grey mask."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = []
    for _ in range(2):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.1, 0.3) * w
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        planes.append(np.clip((1.2 - d) * 4, 0, 1) * 255)
    if c == 1:
        return np.maximum(planes[0], planes[1]).astype(np.uint8)
    return np.stack([np.zeros((h, w)), planes[1], planes[0]], -1).astype(np.uint8)


def png_filters(data: bytes) -> list:
    """The scanline filter types a PNG uses (8-bit, one IDAT stream)."""
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, ctype = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big"), body[9]
            ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw, stride = zlib.decompress(idat), w * ch + 1
    return sorted({raw[y * stride] for y in range(h)})


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def versions() -> dict:
    info = cv2.getBuildInformation()
    jpeg = re.search(r"JPEG:\s+.*?\(ver ([^)]+)\)", info)
    png = re.search(r"PNG:\s+.*?\(ver ([^)]+)\)", info)
    return {"cv2": cv2.__version__, "libjpeg-turbo": jpeg.group(1) if jpeg else None,
            "libpng": png.group(1) if png else None}


def main() -> None:
    rng = np.random.RandomState(SEED)
    files = {}
    for name, (h, w, c, opts) in JPEGS.items():
        img = smooth_image(rng, h, w, c, noise=2.0)
        ok, buf = cv2.imencode(".jpg", img if c == 3 else img[..., 0], opts)
        assert ok, name
        files[name] = buf.tobytes()
    for name, (h, w, c) in MASKS.items():
        ok, buf = cv2.imencode(".png", mask_image(rng, h, w, c), [cv2.IMWRITE_PNG_COMPRESSION, 3])
        assert ok, name
        files[name] = buf.tobytes()
    ok, buf = cv2.imencode(".png", smooth_image(rng, 512, 512, 3, noise=0.0),
                           [cv2.IMWRITE_PNG_COMPRESSION, 9])
    assert ok
    files[TEXTURE] = buf.tobytes()

    manifest = {"versions": versions(), "files": {}, "resizes": []}
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        arr = cv2.imread(str(HERE / name))
        entry = {"sha256": sha(data), "shape": list(arr.shape),
                 "imread_sha256": sha(np.ascontiguousarray(arr).tobytes())}
        if name.endswith(".png"):
            entry["png_filters"] = png_filters(data)
        manifest["files"][name] = entry
    for name, (w, h) in RESIZES:
        out = cv2.resize(cv2.imread(str(HERE / name)), (w, h))
        manifest["resizes"].append({"source": name, "dsize": [w, h], "shape": list(out.shape),
                                    "sha256": sha(np.ascontiguousarray(out).tobytes())})
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} images, {total / 1024:.0f} KiB in all")


if __name__ == "__main__":
    main()
