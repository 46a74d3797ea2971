"""Reference-faithful command-line parser.

A re-design of the reference's spec-table parser
(reference: src/command_line_parser.c) with byte-identical stdout/stderr:
short-option clusters (an argument-taking option must end its cluster),
long options with ``--opt arg`` and ``--opt=arg`` forms, duplicate-option
and unknown-option diagnostics, and the ``%-20s %-18s  %s``-formatted help
listing. Errors are printed to stderr exactly as the C program prints them
(including trailing spaces) and reported by return value.

The port's own copy of ``aad_tpu.cliparse``, which it may not import.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Optional


@dataclasses.dataclass
class OptionSpec:
    """One row of the parser spec table (reference:
    src/command_line_parser.h struct CommandLineParserSpecification)."""

    short: str
    long: Optional[str]
    need_argument: bool
    description: str
    default: Optional[str] = None
    acquired: bool = False
    argument: Optional[str] = None

    def reset(self) -> None:
        self.acquired = False
        self.argument = self.default


def print_description(specs: list[OptionSpec], out=None) -> None:
    """Help listing (reference: src/command_line_parser.c:59-102)."""
    out = out or sys.stdout
    for s in specs:
        attr = "(needs argument)" if s.need_argument else ""
        if s.long is not None:
            cmd = f"  -{s.short}, --{s.long}"
        else:
            cmd = f"  -{s.short}"
        out.write(f"{cmd:<20} {attr:<18}  {s.description} \n")


def parse_arguments(
    specs: list[OptionSpec],
    argv: list[str],
    max_other_strings: int = 2,
    err=None,
) -> Optional[list[str]]:
    """Parse argv (argv[0] = program name).

    Returns the list of non-option strings on success, or None after
    printing the reference-exact diagnostic to stderr
    (reference: src/command_line_parser.c:172-331).
    """
    err = err or sys.stderr
    prog = argv[0]
    for s in specs:
        s.reset()
    others: list[str] = []

    count = 1
    while count < len(argv):
        arg = argv[count]
        if arg.startswith("--"):
            matched = None
            for s in specs:
                if s.long is None or not arg[2:].startswith(s.long):
                    continue
                rest = arg[2 + len(s.long):]
                if rest == "":
                    if s.acquired:
                        err.write(
                            f'{prog}: Option "{s.long}" multiply specified. \n'
                        )
                        return None
                    if s.need_argument:
                        if count + 1 == len(argv) or argv[count + 1].startswith("-"):
                            err.write(
                                f'{prog}: Option "{s.long}" needs argument. \n'
                            )
                            return None
                        count += 1
                        s.argument = argv[count]
                elif rest.startswith("="):
                    if not s.need_argument:
                        continue  # may match an option whose name has '='
                    if s.acquired:
                        err.write(
                            f'{prog}: Option "{s.long}" multiply specified. \n'
                        )
                        return None
                    s.argument = rest[1:]
                else:
                    continue  # longer name; maybe another spec matches
                s.acquired = True
                matched = s
                break
            if matched is None:
                err.write(f'{prog}: Unknown long option - "{arg[2:]}" \n')
                return None
        elif arg.startswith("-"):  # a bare "-" is an empty cluster: no-op
            i = 1
            while i < len(arg):
                ch = arg[i]
                spec = next((s for s in specs if s.short == ch), None)
                if spec is None:
                    err.write(f"{prog}: Unknown short option - '{ch}' \n")
                    return None
                if spec.acquired:
                    err.write(f"{prog}: Option '{ch}' multiply specified. \n")
                    return None
                if spec.need_argument:
                    if i + 1 != len(arg):
                        err.write(
                            f"{prog}: Option '{ch}' needs argument. "
                            "Please specify tail of short option sequence.\n"
                        )
                        return None
                    if count + 1 == len(argv) or argv[count + 1].startswith("-"):
                        err.write(f"{prog}: Option '{ch}' needs argument. \n")
                        return None
                    count += 1
                    spec.argument = argv[count]
                spec.acquired = True
                i += 1
        else:
            if len(others) >= max_other_strings:
                err.write(f"{prog}: Too many strings specified. \n")
                return None
            others.append(arg)
        count += 1

    return others


def strtol10(s: Optional[str]) -> int:
    """C strtol(s, NULL, 10): leading space/sign/digits; 0 if no digits."""
    m = re.match(r"[ \t\n\r\f\v]*([+-]?\d+)", s or "")
    return int(m.group(1)) if m else 0
