"""User-facing applications: the descriptor server, descriptor images and
videos, the heatmap explorer and grasp-point stream, mesh descriptors, the
annotation and debug viewers, and the serving export."""

INT8_NOT_PORTED = {
    "int8": "int8 serving waits for the int8 slice (ROADMAP queue 1 item 6)",
    "int8_static": "int8 serving waits for the int8 slice (ROADMAP queue 1 item 6)",
}


def add_unported_flags(parser, flags: dict):
    """Flags of the JAX package's CLI that the port accepts only to refuse:
    ``{flag: why}``."""
    for flag, why in flags.items():
        parser.add_argument(f"--{flag}", action="store_true", help=f"not ported: {why}")


def reject_unported_flags(parser, args, flags: dict):
    """Exit 2 (``parser.error``) naming the first of ``flags`` that is set."""
    for flag, why in flags.items():
        if getattr(args, flag):
            parser.error(f"--{flag} is not ported to pdc_tpu_torch yet: {why}")
