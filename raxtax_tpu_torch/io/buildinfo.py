"""Build-info stamping for the log header.

Equivalent of the reference's build.rs + write_build_info
(reference: build.rs:4-29, src/io.rs:92-110): records package version,
runtime (Python/PyTorch) versions and the full command line at the top of
every log file.
"""

from __future__ import annotations

import sys

from .. import __version__


def write_build_info(out) -> None:
    import torch

    cmdline = " ".join(sys.argv)
    out.write(
        f"raxtax-torch {__version__} (python {sys.version.split()[0]}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda})\n"
        f"Command: {cmdline}\n"
        "------------------------------------------------------------\n"
    )
    out.flush()
