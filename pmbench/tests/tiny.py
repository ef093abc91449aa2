"""A cell of the benchmark cut to a size the CPU runs in seconds: the same files
and drivers, the widths shrunk (tests only)."""
from __future__ import annotations

import copy

from pmbench import harness


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.find_cell(harness.benchmark(), workload)
    cfg = copy.deepcopy(cell.config)
    if cfg["family"] == "pm_vqvae":
        cfg["vqvae"].update(embedding_dim=8, num_embeddings=16, hidden_units=8,
                            residual_hidden_units=4)
        cfg["pixel_cnn"].update(image_shape=[4, 4], num_resnet=2, num_filters=8)
        cfg["conditional_dim"] = 16
        cfg["data"].update(train_batch_size=4, image_shape=[16, 16, 3])
        cfg.update(train_examples=64, eval_examples=16)
    if cfg["family"] == "pm_vdvae":
        cfg["model"].update(width=16, latent_dim=4, encoder_blocks="28x2,28d4,7x2,7d7,1x2",
                            decoder_blocks="1x2,7m1,7x2,28m7,28x2")
        cfg["data"]["train_batch_size"] = 8
        cfg["train_examples"] = 64
    traffic = dict(cell.traffic)
    if traffic["kind"] == "impute":
        traffic.update(batch=2, samples=2)
    cell.config, cell.traffic = cfg, traffic
    return cell
