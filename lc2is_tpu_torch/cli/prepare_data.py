"""ADE20K preparation CLI, the reference's ``prepare_ade20k.py`` surface
(``data/ade20k/prepare_ade20k.py:31-35``)::

    python -m lc2is_tpu_torch.cli.prepare_data DOWNLOAD_DIR

It downloads (network needed) and extracts the dataset.
"""

from __future__ import annotations

import argparse

from lc2is_tpu_torch.data.ade20k import prepare_ade20k


def main(argv=None):
    p = argparse.ArgumentParser(description="Initialize ADE20K dataset.")
    p.add_argument("download_dir", type=str)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)
    root = prepare_ade20k(args.download_dir, overwrite=args.overwrite)
    print(f"ADE20K ready at {root}")


if __name__ == "__main__":
    main()
