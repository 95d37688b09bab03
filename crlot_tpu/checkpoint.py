"""Stream-state checkpoint/resume.

The reference is a stateless library (SURVEY.md §5: its only persisted
artifact is the perf baseline file); for multi-hour streaming jobs this
build checkpoints the streaming pipeline state — (ring contents, cursors,
frame counter) as a pytree — so a killed job resumes mid-stream.

Uses orbax-checkpoint when available (async, multi-host-aware), with a plain
.npz fallback that covers single-host use without extra deps.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import jax
import numpy as np

from .core.types import OLAConfig
from .ola.streaming import OLAStreamState


def _to_numpy_tree(tree) -> Dict[str, np.ndarray]:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    out["_treedef"] = np.frombuffer(
        str(treedef).encode(), dtype=np.uint8
    )  # stored for debugging only
    return out


def save_stream_state(
    path: str,
    state: OLAStreamState,
    cfg: OLAConfig,
    frame_index: int,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a resumable checkpoint: OLA ring state + stream position.

    `frame_index` is the next frame counter the producer will push
    (the `frame_count * hop` cursor of the reference e2e loop,
    bench/e2e_benchmark.cc:168).
    """
    meta = {
        "version": 1,
        "frame_index": int(frame_index),
        "cfg": {
            "sample_rate": cfg.sample_rate,
            "frame_size": cfg.frame_size,
            "hop_size": cfg.hop_size,
            "channels": cfg.channels,
            "eps": cfg.eps,
            "apply_window_inside": cfg.apply_window_inside,
            "ring_margin_hops": cfg.ring_margin_hops,
        },
        "extra": extra or {},
    }
    tmp = path + ".tmp.npz"  # atomic write: tmp then rename
    np.savez(
        tmp,
        ring=np.asarray(state.ring),
        read_pos=np.asarray(state.read_pos),
        produced=np.asarray(state.produced),
        flushed=np.asarray(state.flushed),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)


def load_stream_state(path: str):
    """Returns (state, cfg, frame_index, extra)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") != 1:
            raise ValueError(f"unsupported checkpoint version: {meta.get('version')}")
        import jax.numpy as jnp

        state = OLAStreamState(
            ring=jnp.asarray(z["ring"]),
            read_pos=jnp.asarray(z["read_pos"]),
            produced=jnp.asarray(z["produced"]),
            flushed=jnp.asarray(z["flushed"]),
        )
    cfg = OLAConfig(**meta["cfg"])
    return state, cfg, meta["frame_index"], meta["extra"]


def save_stream_state_orbax(path: str, state: OLAStreamState) -> bool:
    """Orbax variant for multi-host jobs; returns False if orbax missing."""
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        return False
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(os.path.abspath(path), state._asdict(), force=True)
    ckpt.wait_until_finished()
    return True


def load_stream_state_orbax(path: str) -> Optional[OLAStreamState]:
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        return None
    ckpt = ocp.StandardCheckpointer()
    d = ckpt.restore(os.path.abspath(path))
    import jax.numpy as jnp

    return OLAStreamState(**{k: jnp.asarray(v) for k, v in d.items()})
