"""End-to-end fault-tolerant training of the port (port of
`examples/train_tiny_lm.py`): synthetic data pipeline -> AdamW ->
periodic async checkpoints -> (optional) injected crash -> the restart
continues bit-exact.  It drives `repro_torch.launch.train`.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm          # 120 steps
    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm --crash  # crash + resume

(`--device cpu` on a machine without a card; `--steps`, `--seq-len` and
`--checkpoint-dir` size a shorter run.)  The production path is the same
code at scale, on a mesh over torchrun's processes:
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch yi-34b \\
        --mesh 4x2 --steps 10000
"""

import argparse
import os
import shutil
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--crash", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt"))
    args = ap.parse_args(argv)

    shutil.rmtree(args.checkpoint_dir, ignore_errors=True)
    every, fail = max(args.steps // 3, 1), args.steps // 2
    base = ["--arch", "smollm-360m", "--smoke", "--steps", str(args.steps),
            "--batch", "8", "--seq-len", str(args.seq_len), "--checkpoint-every", str(every),
            "--checkpoint-dir", args.checkpoint_dir, "--device", args.device]
    if args.crash:
        print(f"== run 1: will crash at step {fail} (a checkpoint exists at {every}) ==")
        try:
            train_mod.main(base + ["--fail-at", str(fail)])
        except RuntimeError as e:
            print(f"   crashed as planned: {e}")
        print("== run 2: auto-resume from the latest checkpoint ==")
    return train_mod.main(base)


if __name__ == "__main__":
    main()
