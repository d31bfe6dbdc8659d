"""Write the JPEG fixtures of ``tests/fixtures/jpeg/`` and their manifest.

Each image is a seeded smooth colour field (a sum of low-frequency cosines)
plus pixel noise, at one of ImageNet's common shapes, encoded by PIL; one
file is grayscale, one progressive, and one is smaller than 224 pixels so
the resize enlarges it.  ``MANIFEST.json`` records each file's sha256 and,
for the native pipeline's 224-pixel ``decode_and_preprocess`` output (CLIP
statistics), its sha256, its absmax and its 8 x 8 average pool per channel,
which hosts whose libjpeg rounds its IDCT differently are held to within a
tolerance.  Run from the repository root:

    python3 scripts/make_jpeg_fixtures.py

It needs PIL, g++ and the libjpeg headers.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from vit_prisma_tpu_torch.dataloaders import native  # noqa: E402

OUT = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "jpeg"
SHAPES = [(500, 375), (375, 500), (500, 333), (640, 480), (500, 500)]  # (width, height)
N_FILES = 28
SMALL = (200, 150)
QUALITY = 85
OUT_SIZE = 224
POOL = 8


def field(rng, w, h):
    """A smooth RGB field in [0, 255] with pixel noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 4.0, size=2) * 2 * np.pi
            phase = rng.uniform(0, 2 * np.pi)
            img[..., c] += rng.uniform(20, 50) * np.cos(fx * x / w + fy * y / h + phase)
    img += 128 + rng.normal(0, 6, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pooled(chw):
    c, s, _ = chw.shape
    return chw.reshape(c, POOL, s // POOL, POOL, s // POOL).mean(axis=(2, 4))


def main():
    from PIL import Image
    OUT.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2026)
    files = []
    for i in range(N_FILES):
        w, h = SMALL if i == N_FILES - 1 else SHAPES[i % len(SHAPES)]
        img = Image.fromarray(field(rng, w, h))
        kind, kwargs = "rgb", {}
        if i == 5:
            img, kind = img.convert("L"), "gray"
        if i == 6:
            kind, kwargs = "progressive", {"progressive": True}
        name = f"{i:02d}_{w}x{h}_{kind}.jpg"
        img.save(OUT / name, "JPEG", quality=QUALITY, **kwargs)
        data = (OUT / name).read_bytes()
        out = native.decode_and_preprocess(data, OUT_SIZE)
        files.append({"name": name, "width": w, "height": h, "kind": kind,
                      "sha256": hashlib.sha256(data).hexdigest(),
                      "out_sha256": hashlib.sha256(out.tobytes()).hexdigest(),
                      "out_absmax": float(np.abs(out).max()),
                      "out_pool8": np.round(pooled(out), 6).tolist()})
    manifest = {"out_size": OUT_SIZE, "mean_std": "CLIP", "pool": POOL,
                "quality": QUALITY, "files": files}
    (OUT / "MANIFEST.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum((OUT / f["name"]).stat().st_size for f in files)
    print(f"{len(files)} files, {total} bytes")


if __name__ == "__main__":
    main()
