"""Print the fully resolved config, ``_base_`` files merged and overrides
applied (counterpart: ``tools/misc/print_config.py``).

    python -m gkgnet_tpu_torch.tools.misc.print_config CONFIG \\
        [--cfg-options k=v ..]
"""

from __future__ import annotations

import argparse

from gkgnet_tpu_torch.tools.train import load_config


def main(argv=None) -> str:
    """Returns the printed text."""
    p = argparse.ArgumentParser(description="Print the merged config")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    text = load_config(args.config, args.cfg_options).pretty_text()
    print(text)
    return text


if __name__ == "__main__":
    main()
