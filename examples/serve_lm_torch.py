"""Batched serving on the PyTorch port: prefill + KV-cache decode on a
reduced gemma2-family model (local/global alternating layers, ring caches
for the sliding-window layers).  It runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

seqs = serve_main(["--arch", "gemma2-2b", "--reduced", "--batch", "4",
                   "--prompt-len", "32", "--gen", "24",
                   "--temperature", "0.7", "--device", args.device])
assert tuple(seqs.shape) == (4, 32 + 24), seqs.shape
print("served 4 sequences ✓")
