"""Scene-graph pair construction (port of instantsplat_tpu/init/pairs.py;
reference dust3r/image_pairs.py:11-68).

InstantSplat uses scene_graph='complete' with symmetrize=True
(init_geo.py:43), giving all N(N-1) directed pairs. The windowed variants
are provided for completeness.
"""

from __future__ import annotations


def make_pair_indices(n, scene_graph="complete", symmetrize=True):
    """-> list of (i, j) directed index pairs."""
    pairs = []
    if scene_graph == "complete":
        for i in range(n):
            for j in range(i):
                pairs.append((i, j))
    elif scene_graph.startswith("swin"):
        winsize = int(scene_graph.split("-")[1]) if "-" in scene_graph else 3
        for i in range(n):
            for j in range(1, winsize + 1):
                pairs.append((i, (i + j) % n))
    elif scene_graph.startswith("logwin"):
        winsize = int(scene_graph.split("-")[1]) if "-" in scene_graph else 3
        offsets = [2**k for k in range(winsize)]
        for i in range(n):
            for off in offsets:
                if i + off < n:
                    pairs.append((i, i + off))
    elif scene_graph.startswith("oneref"):
        ref = int(scene_graph.split("-")[1]) if "-" in scene_graph else 0
        for j in range(n):
            if j != ref:
                pairs.append((ref, j))
    else:
        raise ValueError(f"unknown scene graph: {scene_graph}")

    if symmetrize:
        seen = set(pairs)
        pairs = pairs + [(j, i) for i, j in pairs if (j, i) not in seen]
    return pairs
