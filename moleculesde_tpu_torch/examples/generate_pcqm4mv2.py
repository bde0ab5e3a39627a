"""One-off PCQM4Mv2 preprocessing (reference examples/generate_PCQM4Mv2.py).

Counterpart of ``examples/generate_pcqm4mv2.py`` of the JAX package:
featurizes the raw CSV and SDF under ``<--input_data_dir>/<--dataset>``
into the packed flat-array cache (``data/packed.py``) that the pretraining
and sampler CLIs reload memory-mapped in seconds, the counterpart of the
reference's collated ``geometric_data_processed.pt``
(dataset_PCQM4Mv2.py:45-77).  The cache's format is the JAX package's, so
either package's cache serves the other.  Needs RDKit; nothing here runs
on the GPU.

Example:
  python -m moleculesde_tpu_torch.examples.generate_pcqm4mv2 --input_data_dir=data \\
      --dataset=PCQM4Mv2
"""

from __future__ import annotations

import argparse
import os

from moleculesde_tpu_torch.data.datasets import load_pcqm4mv2


def get_parser() -> argparse.ArgumentParser:
    """The four flags of the JAX CLI's parser (examples/config.py) that this
    script reads, with their names and defaults."""
    p = argparse.ArgumentParser()
    p.add_argument("--input_data_dir", type=str, default="")
    p.add_argument("--dataset", type=str, default="QM9")
    p.add_argument("--max_molecules", type=int, default=0,
                   help="cap on the molecules kept (0 -> all)")
    p.add_argument("--use_extend_graph", dest="use_extend_graph", action="store_true")
    p.add_argument("--no_extend_graph", dest="use_extend_graph", action="store_false")
    p.set_defaults(use_extend_graph=True)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    root = os.path.join(args.input_data_dir, args.dataset or "PCQM4Mv2")
    graphs = load_pcqm4mv2(root, max_molecules=args.max_molecules or None,
                           extend=args.use_extend_graph)
    size_gb = graphs.nbytes() / 1e9
    print(f"processed {len(graphs)} molecules into the packed cache under "
          f"{root} ({size_gb:.2f} GB of flat arrays, memory-mapped on reload)")


if __name__ == "__main__":
    main()
