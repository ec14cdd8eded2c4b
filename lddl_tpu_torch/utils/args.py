"""argparse helpers shared by the CLIs.

The port's own copy of ``lddl_tpu/utils/args.py`` (``attach_bool_arg``,
``parse_str_of_num_bytes``).
"""

import argparse


def attach_bool_arg(parser, flag_name, default=False, help_str=None):
    """Attach paired ``--x / --no-x`` boolean flags."""
    attr_name = flag_name.replace("-", "_")
    group = parser.add_mutually_exclusive_group()
    help_str = help_str if help_str is not None else flag_name
    group.add_argument(
        "--" + flag_name,
        dest=attr_name,
        action="store_true",
        help=help_str + " (default: {})".format(default),
    )
    group.add_argument(
        "--no-" + flag_name,
        dest=attr_name,
        action="store_false",
        help="disable: " + help_str,
    )
    parser.set_defaults(**{attr_name: default})


def parse_str_of_num_bytes(s, return_str=False):
    """'512M'/'4G'/'128K'/plain int -> byte count."""
    try:
        power = "kmg".find(s[-1].lower()) + 1
        size = float(s[:-1]) * 1024**power if power > 0 else float(s)
    except (ValueError, IndexError):
        raise argparse.ArgumentTypeError("Invalid size: {}".format(s))
    if size < 0:
        raise argparse.ArgumentTypeError("Size must be non-negative: {}".format(s))
    if return_str:
        return s
    return int(size)
