"""GMSH mesh-node loader (the ``testing/gmsh.hpp`` analog): reads node
coordinates from MSH ASCII files (v2.2 ``$Nodes`` and v4.1
``$Nodes``-block formats), returning [n, 3] coordinates for use as a
point cloud.

A copy of ``htool_tpu/testing/gmsh.py`` (NumPy only)."""

from __future__ import annotations

import numpy as np

__all__ = ["load_gmsh_nodes"]


def load_gmsh_nodes(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    try:
        i_fmt = lines.index("$MeshFormat")
        version = float(lines[i_fmt + 1].split()[0])
        i0 = lines.index("$Nodes")
        i1 = lines.index("$EndNodes")
    except ValueError as e:
        raise ValueError(f"{path}: not a GMSH ASCII mesh ({e})") from None
    body = lines[i0 + 1 : i1]
    if version < 4.0:
        # v2.2: count, then "id x y z" per line
        n = int(body[0])
        out = np.empty((n, 3))
        for k in range(n):
            parts = body[1 + k].split()
            out[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
        return out
    # v4.1: numEntityBlocks numNodes minTag maxTag; per block: header,
    # tags, then coordinates
    header = body[0].split()
    n_blocks, n_nodes = int(header[0]), int(header[1])
    out = np.empty((n_nodes, 3))
    pos = 1
    written = 0
    for _ in range(n_blocks):
        blk = body[pos].split()
        n_in_block = int(blk[3])
        pos += 1 + n_in_block  # skip tags
        for k in range(n_in_block):
            parts = body[pos + k].split()
            out[written] = [float(parts[0]), float(parts[1]), float(parts[2])]
            written += 1
        pos += n_in_block
    return out[:written]
