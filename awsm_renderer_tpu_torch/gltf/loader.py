"""glTF 2.0 / GLB loader (filesystem + data URIs).

Port of the reference's loader (crates/renderer/src/gltf/loader.rs:21-95:
fetch .gltf/.glb + buffers + images, type detection by extension). No
network here — files come from disk; images decode via PIL.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..errors import GltfError


@dataclass
class GltfData:
    """Parsed document + raw binary buffers + decoded images.

    Reference: gltf/data.rs (doc + buffers + hints)."""

    gltf: dict
    buffers: List[bytes]
    images: List[np.ndarray] = field(default_factory=list)  # (H,W,4) uint8
    hud: bool = False


def _decode_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        _, b64 = uri.split(",", 1)
        return base64.b64decode(b64)
    path = os.path.join(base_dir, uri)
    with open(path, "rb") as f:
        return f.read()


def _decode_image(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img)


def load_gltf(path: str, hud: bool = False) -> GltfData:
    """Load .gltf or .glb from disk (type by extension, like loader.rs)."""
    base_dir = os.path.dirname(path)
    with open(path, "rb") as f:
        raw = f.read()

    bin_chunk: Optional[bytes] = None
    if path.endswith(".glb") or raw[:4] == b"glTF":
        magic, version, _length = struct.unpack_from("<4sII", raw, 0)
        if magic != b"glTF":
            raise GltfError("bad GLB magic")
        if version != 2:
            raise GltfError(f"unsupported GLB version {version}")
        offset = 12
        gltf = None
        while offset < len(raw):
            chunk_len, chunk_type = struct.unpack_from("<II", raw, offset)
            chunk = raw[offset + 8 : offset + 8 + chunk_len]
            if chunk_type == 0x4E4F534A:  # JSON
                gltf = json.loads(chunk)
            elif chunk_type == 0x004E4942:  # BIN
                bin_chunk = chunk
            offset += 8 + chunk_len + (-chunk_len) % 4
        if gltf is None:
            raise GltfError("GLB missing JSON chunk")
    else:
        gltf = json.loads(raw)

    buffers: List[bytes] = []
    for buf in gltf.get("buffers", []):
        if "uri" in buf:
            buffers.append(_decode_uri(buf["uri"], base_dir))
        else:
            if bin_chunk is None:
                raise GltfError("buffer without uri outside GLB")
            buffers.append(bin_chunk)

    images: List[np.ndarray] = []
    for img in gltf.get("images", []):
        if "uri" in img:
            images.append(_decode_image(_decode_uri(img["uri"], base_dir)))
        else:
            bv = gltf["bufferViews"][img["bufferView"]]
            data = buffers[bv["buffer"]]
            off = bv.get("byteOffset", 0)
            images.append(_decode_image(data[off : off + bv["byteLength"]]))

    return GltfData(gltf=gltf, buffers=buffers, images=images, hud=hud)
