"""End-to-end LM training on the PyTorch port: trains a reduced
qwen3-family model through the port's train CLI
(``repro_torch.launch.train``), with checkpoints and resume.  It runs on
the card unless ``--device cpu`` is given; with several cards visible,
``--device cuda`` trains sharded over a mesh of all of them.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu [--steps 200]
"""
import argparse
import os

from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--arch", default="qwen3-1.7b")
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--device", default="cuda")
ap.add_argument("--out-dir", default="runs")
args = ap.parse_args()

history = train_main([
    "--arch", args.arch, "--reduced",
    "--steps", str(args.steps),
    "--batch", str(args.batch),
    "--seq", str(args.seq),
    "--lr", "3e-3",
    "--device", args.device,
    "--ckpt-dir", os.path.join(args.out_dir, "example_torch_ckpt"),
    "--ckpt-every", "100",
    "--metrics-out", os.path.join(args.out_dir,
                                  "example_torch_train_metrics.json"),
])

first, last = history[0]["loss"], history[-1]["loss"]
print(f"loss {first:.3f} -> {last:.3f}")
assert last < first, "training did not reduce loss"
print("training reduced loss ✓")
