"""Offline preprocessing tools (the reference's standalone binaries):
``python -m acg_tpu_torch.tools.{genmatrix,mtx2bin,mtxpartition}``."""

from __future__ import annotations


def add_parity_flags(parser, prog: str) -> None:
    """Register the reference CLIs' shared drop-in flags (gzip family,
    -q/--quiet, --version) on ``parser`` -- one definition for every
    tool so the compatibility surface cannot drift between them."""
    for flag in ("--gzip", "--gunzip", "--ungzip"):
        parser.add_argument(flag, action="store_true",
                            help="accepted for drop-in compatibility; "
                                 "gzip input is auto-detected")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress diagnostic output")
    parser.add_argument("--version", action="version",
                        version=f"{prog} (acg_tpu_torch)")


def apply_quiet(args) -> None:
    """--quiet wins over --verbose (the reference tools' precedence)."""
    if getattr(args, "quiet", False):
        args.verbose = 0
