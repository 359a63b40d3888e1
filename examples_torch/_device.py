"""The examples' shared command line: ``--device cpu`` runs an example on
the CPU (the plain versions of the kernels); without it, on the GPU."""

import argparse


def parse_device(doc: str):
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the GPU by default")
    return ap.parse_args().device
