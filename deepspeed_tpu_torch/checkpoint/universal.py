"""Universal checkpoint utilities.

Own copy of ``deepspeed_tpu/checkpoint/universal.py`` (numpy over
``runtime/checkpoint_engine/serialization.py``), the counterpart of the
reference's ``deepspeed/checkpoint/`` (``ds_to_universal.py``,
``universal_checkpoint.py``, ``utils/zero_to_fp32.py``). The engines of
both packages write GLOBAL logical tensors in one format, so any ZeRO
stage or process count loads any checkpoint directly, and these tools
read a tag written by either package:

  * ``consolidate_to_fp32`` — zero_to_fp32: the fp32 master weights of a
    training checkpoint into a standalone flat file (no optimizer state).
  * ``ds_to_universal`` — one file per logical parameter (the reference's
    universal layout), so external tools can stream single tensors.
  * ``inspect_checkpoint`` — key/shape/dtype listing.

All functions take a checkpoint dir (with ``latest``), a tag dir, or a
direct ``state.npz`` path.
"""

import json
import os

import numpy as np

from ..runtime.checkpoint_engine import serialization as ser


def _resolve(path_or_dir, tag=None):
    """-> loadable location: a direct .npz file path, or a tag directory
    (legacy monolithic state.npz or the sharded per-host layout — both
    handled by serialization.load_state)."""
    if (os.path.isdir(path_or_dir)
            and not os.path.exists(os.path.join(path_or_dir, "latest"))
            and (os.path.exists(os.path.join(path_or_dir, "state.npz"))
                 or any(f.startswith("shard-")
                        for f in os.listdir(path_or_dir)))):
        return path_or_dir  # already a tag dir
    if os.path.isdir(path_or_dir):
        if tag is None:
            with open(os.path.join(path_or_dir, "latest")) as f:
                tag = f.read().strip()
        return os.path.join(path_or_dir, tag)
    return path_or_dir


def _load(path_or_dir, tag=None):
    loc = _resolve(path_or_dir, tag)
    if os.path.isdir(loc):
        return ser.load_state(loc)
    return ser.load_file(loc)


def consolidate_to_fp32(ckpt, output_path, tag=None):
    """reference utils/zero_to_fp32.py: training checkpoint -> standalone
    fp32 weights file (master subtree only). Returns #params written."""
    flat, header = _load(ckpt, tag)
    master = {k[len("master/"):]: v for k, v in flat.items()
              if k.startswith("master/")}
    if not master:
        raise ValueError("checkpoint has no master weights subtree")
    arrays = {k.replace("/", "%2F"): np.asarray(v, np.float32)
              for k, v in master.items()}
    meta = {"format": "dstpu-fp32-consolidated", "version": 1,
            "num_params": int(sum(a.size for a in arrays.values()))}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                exist_ok=True)
    with open(output_path, "wb") as f:
        np.savez(f, **arrays)
    return meta["num_params"]


def load_consolidated(path):
    """-> flat dict param_path -> fp32 array (nest with '/' in keys)."""
    with np.load(path, allow_pickle=False) as z:
        return {k.replace("%2F", "/"): z[k] for k in z.files
                if k != "__meta__"}


def ds_to_universal(ckpt, out_dir, tag=None):
    """reference checkpoint/ds_to_universal.py: one .npy per logical
    param + index json. Returns the index dict."""
    flat, header = _load(ckpt, tag)
    os.makedirs(out_dir, exist_ok=True)
    index = {}
    for key, arr in flat.items():
        safe = key.replace("/", "%2F")
        fname = f"{safe}.npy"
        np.save(os.path.join(out_dir, fname), np.asarray(arr))
        index[key] = {"file": fname, "shape": list(np.shape(arr)),
                      "dtype": str(np.asarray(arr).dtype)}
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({"params": index, "extra": header.get("extra", {}),
                   "meta": header.get("meta", {})}, f, indent=2)
    return index


def load_universal_param(universal_dir, key):
    """Stream ONE logical parameter from a universal dir."""
    with open(os.path.join(universal_dir, "index.json")) as f:
        index = json.load(f)["params"]
    if key not in index:
        raise KeyError(f"{key} not in universal checkpoint "
                       f"({len(index)} params)")
    return np.load(os.path.join(universal_dir, index[key]["file"]))


def inspect_checkpoint(ckpt, tag=None, file=None):
    """Print key/shape/dtype/bytes for every tensor; returns total
    bytes."""
    import sys
    f = file or sys.stdout
    flat, header = _load(ckpt, tag)
    total = 0
    for key in sorted(flat):
        arr = np.asarray(flat[key])
        total += arr.nbytes
        print(f"  {key:48s} {str(arr.shape):18s} {arr.dtype} "
              f"{arr.nbytes / 1e6:8.2f}MB", file=f)
    extra = header.get("extra", {})
    print(f"total {total / 1e6:.2f}MB; step={extra.get('global_step')} "
          f"zero_stage={extra.get('zero_stage')}", file=f)
    return total


def main(argv=None):
    """CLI: ``python -m deepspeed_tpu_torch.checkpoint.universal <cmd> ...``
    cmds: fp32 <ckpt> <out>, universal <ckpt> <out_dir>, inspect <ckpt>"""
    import argparse
    p = argparse.ArgumentParser(prog="dstpu-checkpoint")
    sub = p.add_subparsers(dest="cmd", required=True)
    f32 = sub.add_parser("fp32")
    f32.add_argument("ckpt")
    f32.add_argument("output")
    uni = sub.add_parser("universal")
    uni.add_argument("ckpt")
    uni.add_argument("out_dir")
    ins = sub.add_parser("inspect")
    ins.add_argument("ckpt")
    args = p.parse_args(argv)
    if args.cmd == "fp32":
        n = consolidate_to_fp32(args.ckpt, args.output)
        print(f"wrote {n} fp32 params to {args.output}")
    elif args.cmd == "universal":
        idx = ds_to_universal(args.ckpt, args.out_dir)
        print(f"wrote {len(idx)} tensors to {args.out_dir}")
    else:
        inspect_checkpoint(args.ckpt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
