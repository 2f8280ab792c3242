"""Episodic few-shot training driver (counterpart of the JAX package's
train_fs.py): cli/train.py's loop over FSInstDataset episodes with
GeoFormerFS.

    python3 -m geoformer_tpu_torch.cli.train_fs --config CONFIG.yaml \\
        --pretrain SUPERVISED.ckpt [--output_path exp] [--exp_name NAME] [--device cpu]

Starts from a supervised checkpoint (``--pretrain``; the encoder-to-decoder
projection widens from 2m to 6m, so that leaf is skipped on its shape) and
trains with the config's ``fix_module`` frozen.
"""

from __future__ import annotations

from geoformer_tpu_torch.cli.train import run


def main(argv=None) -> dict:
    return run(argv, few_shot=True)


if __name__ == "__main__":
    main()
