"""Scene and BVH introspection (port of ``cudatracerlib_tpu/utils/introspect.py``).

- scene_memory_stats / format_memory_stats: per-table device-memory
  accounting, the counterpart of ``DynamicScene::printInfo`` +
  ``getCudaBufferSize`` (reference ``Engine/DynamicScene.cpp:619-636``).
- bvh_to_graphviz: DOT dump of the 8-wide fat-row BVH, the counterpart of
  ``SceneBVH::printGraph`` (reference ``Engine/SceneBVH.h:41``).
"""
from __future__ import annotations

import numpy as np
import torch


def _tensors(x, prefix):
    """(dotted name, tensor) for every tensor in nested NamedTuples."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from _tensors(getattr(x, f), f"{prefix}.{f}" if prefix else f)


def scene_memory_stats(scene) -> dict:
    """Bytes of device memory per scene table (tensor), plus 'total'.

    Keys are dotted paths into the SceneData (e.g. 'geom.wide',
    'textures.texels_quad'), as the JAX package's pytree paths; values are
    bytes. The host-side metadata (``SceneData.host``) is not counted."""
    stats = {name: t.numel() * t.element_size() for name, t in _tensors(scene, "")}
    stats["total"] = sum(stats.values())
    return stats


def format_memory_stats(stats: dict, top: int = 16) -> str:
    """Human-readable table, largest first (reference printInfo string)."""
    rows = sorted(((v, k) for k, v in stats.items() if k != "total"),
                  reverse=True)
    out = [f"{'table':<32} {'bytes':>14} {'MB':>9}"]
    for v, k in rows[:top]:
        out.append(f"{k:<32} {v:>14,} {v / 1e6:>9.2f}")
    rest = sum(v for v, _ in rows[top:])
    if rest:
        out.append(f"{'(other)':<32} {rest:>14,} {rest / 1e6:>9.2f}")
    t = stats["total"]
    out.append(f"{'TOTAL':<32} {t:>14,} {t / 1e6:>9.2f}")
    return "\n".join(out)


def bvh_to_graphviz(wide, root: int = 0, max_nodes: int = 256) -> str:
    """DOT graph of a unified fat-row BVH8 table (ops/traversal8 layout:
    node rows carry 8 child links at f32 slots 48:56 as int32 bit patterns;
    link >= 0 -> child node row, link <= -2 -> leaf row -2-link, -1 empty;
    leaf rows carry the triangle count at slot 120). `wide` is a tensor on
    any device or a numpy array.

    Truncates after max_nodes interior nodes (noted in the graph). Render
    with ``dot -Tpng``. Reference: SceneBVH::printGraph (SceneBVH.h:41).
    """
    w = wide.cpu().numpy() if isinstance(wide, torch.Tensor) else np.asarray(wide)
    lines = ["digraph bvh8 {", "  node [shape=box, fontsize=9];"]
    stack = [int(root)]
    seen = 0
    truncated = False
    while stack:
        n = stack.pop()
        if seen >= max_nodes:
            truncated = True
            break
        seen += 1
        links = w[n, 48:56].view(np.int32)
        lo = w[n, 0:24].reshape(3, 8)
        hi = w[n, 24:48].reshape(3, 8)
        used = links != -1
        ext = np.where(used, (hi - lo).sum(0), 0.0)
        lines.append(
            f'  n{n} [label="node {n}\\nchildren {int(used.sum())}  '
            f'max-extent {ext.max():.3g}"];')
        for li in links[used]:
            li = int(li)
            if li >= 0:
                lines.append(f"  n{n} -> n{li};")
                stack.append(li)
            else:
                leaf = -2 - li
                k = int(w[leaf, 120])
                lines.append(
                    f'  l{leaf} [label="leaf {leaf}\\n{k} tris", '
                    f"shape=ellipse];")
                lines.append(f"  n{n} -> l{leaf};")
    if truncated:
        lines.append('  trunc [label="... truncated", shape=plaintext];')
    lines.append("}")
    return "\n".join(lines)
