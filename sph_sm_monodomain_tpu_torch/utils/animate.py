"""Minimal GIF89a writer — assembles rendered frame sequences into one
animation file (mirror of `sph_sm_monodomain_tpu.utils.animate`; component
C15's last delta: the reference shipped a demo
video, .MISSING_LARGE_BLOBS:1, and an interactive GLUT window; the headless
framework renders PNG frames and packages them here).

Pure numpy + a hand-rolled LZW encoder: the environment ships no PIL /
imageio / ffmpeg, and a GIF is small enough to write directly. Colors are
quantized to the 6x6x6 web cube plus a 40-step gray ramp (the renderer's
displacement/voltage colormaps are smooth ramps, which the cube covers
within ~2% per channel).
"""

from __future__ import annotations

import struct

import numpy as np


def _palette() -> np.ndarray:
    """(256, 3) uint8 global color table: 216-color cube + 40 grays."""
    levels = np.array([0, 51, 102, 153, 204, 255], np.uint8)
    cube = np.stack(np.meshgrid(levels, levels, levels,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    grays = np.linspace(0, 255, 40).astype(np.uint8)
    grays = np.stack([grays] * 3, axis=-1)
    return np.concatenate([cube, grays], axis=0)


def _quantize(rgb: np.ndarray) -> np.ndarray:
    """Map (H, W, 3) uint8 to palette indices. Near-gray pixels use the
    40-step gray ramp (finer than the cube's 51-step channel grid)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    cube = (((r + 25) // 51) * 36 + ((g + 25) // 51) * 6
            + (b + 25) // 51).astype(np.int32)
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    gray_idx = 216 + np.clip((mx + mn) // 2 * 40 // 256, 0, 39)
    return np.where(mx - mn < 12, gray_idx, cube).astype(np.uint8)


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF-flavor LZW (variable code width, clear at 4096 entries)."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc = 0
    nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {}
    next_code = end + 1
    width = min_code_size + 1
    emit(clear, width)
    prefix = -1
    for px in indices.ravel().tolist():
        key = (prefix, px)
        if prefix < 0:
            prefix = px
        elif key in table:
            prefix = table[key]
        else:
            emit(prefix, width)
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width):
                width += 1
            if next_code >= 4096:
                emit(clear, width)
                table.clear()
                next_code = end + 1
                width = min_code_size + 1
            prefix = px
    if prefix >= 0:
        emit(prefix, width)
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames, fps: float = 20.0, loop: int = 0) -> None:
    """Write (T, H, W, 3) uint8 frames (or a list of (H, W, 3)) as an
    animated GIF. `loop=0` means loop forever. Uses PIL when present
    (adaptive palette); otherwise the self-contained encoder below (same
    fallback pattern as render.save_png)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    try:
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=max(20, round(1000.0 / fps)), loop=loop)
        return
    except ImportError:
        pass
    h, w = frames[0].shape[:2]
    delay_cs = max(2, round(100.0 / fps))
    pal = _palette()
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        # logical screen: global color table, 8 bits/channel, 256 entries
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(pal.tobytes())
        # netscape looping extension
        f.write(b"\x21\xFF\x0BNETSCAPE2.0\x03\x01"
                + struct.pack("<H", loop) + b"\x00")
        for fr in frames:
            if fr.shape[:2] != (h, w):
                raise ValueError("frame size mismatch")
            # graphic control: delay, no transparency
            f.write(b"\x21\xF9\x04\x00" + struct.pack("<H", delay_cs)
                    + b"\x00\x00")
            f.write(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(b"\x08")  # LZW min code size
            data = _lzw_encode(_quantize(fr))
            for i in range(0, len(data), 255):
                chunk = data[i:i + 255]
                f.write(bytes([len(chunk)]) + chunk)
            f.write(b"\x00")
        f.write(b"\x3B")


def read_png_rgb(path: str) -> np.ndarray:
    """Read an (H, W, 3) uint8 frame written by utils.render.save_png:
    8-bit RGB PNG (no interlace), or the raw P6 PPM its no-PIL fallback
    writes (detected by magic bytes, regardless of extension)."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"P6":
        return _read_ppm_rgb(path)
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        pass
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG"
    pos = 8
    w = h = None
    idat = bytearray()
    while pos < len(data):
        (ln,), typ = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if typ == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype != 2:
                raise ValueError(f"{path}: only 8-bit RGB supported "
                                 f"(depth={depth} ctype={ctype})")
        elif typ == b"IDAT":
            idat.extend(body)
        elif typ == b"IEND":
            break
        pos += 12 + ln
    raw = zlib.decompress(bytes(idat))
    stride = w * 3 + 1
    img = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros((w, 3), np.int32)
    for y in range(h):
        row = np.frombuffer(raw[y * stride:(y + 1) * stride], np.uint8)
        filt, line = row[0], row[1:].reshape(w, 3).astype(np.int32)
        if filt == 0:
            pass
        elif filt == 1:                                  # Sub
            for x in range(1, w):
                line[x] = (line[x] + line[x - 1]) % 256
        elif filt == 2:                                  # Up
            line = (line + prev) % 256
        elif filt == 3:                                  # Average
            for x in range(w):
                left = line[x - 1] if x else np.zeros(3, np.int32)
                line[x] = (line[x] + (left + prev[x]) // 2) % 256
        elif filt == 4:                                  # Paeth
            for x in range(w):
                a = line[x - 1] if x else np.zeros(3, np.int32)
                b = prev[x]
                c = prev[x - 1] if x else np.zeros(3, np.int32)
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a,
                                np.where(pb <= pc, b, c))
                line[x] = (line[x] + pred) % 256
        else:
            raise ValueError(f"{path}: unsupported PNG filter {filt}")
        img[y] = line.astype(np.uint8)
        prev = line
    return img


def _read_ppm_rgb(path: str) -> np.ndarray:
    """Raw (binary) P6 PPM, the exact single-space-header form
    utils.render.save_png's fallback writes."""
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(b"\n", 1)
    magic, w, h, maxval = parts[0].split()
    assert magic == b"P6" and maxval == b"255", f"{path}: unsupported PPM"
    w, h = int(w), int(h)
    return np.frombuffer(parts[1][:w * h * 3],
                         np.uint8).reshape(h, w, 3).copy()
