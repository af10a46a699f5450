"""A faithful reimplementation of glibc's getopt_long.

The reference CLI (src/swarm.cc:269-463) relies on GNU getopt_long
semantics: argument permutation, unambiguous long-option abbreviation,
and glibc's exact stderr diagnostics. Python's stdlib getopt differs in
all three, so this module reimplements the scanner so that command-line
error output is byte-identical to the reference binary.
"""

import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

NO_ARGUMENT = 0
REQUIRED_ARGUMENT = 1


@dataclass
class LongOption:
    name: str
    has_arg: int
    val: str


class GetoptError(Exception):
    """Internal signal: glibc printed a diagnostic and returned '?'."""


def getopt_long(
    argv: List[str],
    progname: str,
    shortopts: str,
    longopts: List[LongOption],
) -> Tuple[List[Tuple[str, Optional[str]]], List[str], bool]:
    """Scan argv (excluding argv[0]).

    Returns (options, positionals, had_error) where options is a list of
    (option_char, argument) events in scan order. On a scan error the
    glibc diagnostic has already been written to stderr, had_error is
    True and scanning stopped at the error (like swarm's '?' handler,
    which exits immediately).
    """
    options: List[Tuple[str, Optional[str]]] = []
    positionals: List[str] = []
    i = 0
    n = len(argv)

    def err(message: str) -> None:
        sys.stderr.write(f"{progname}: {message}\n")

    while i < n:
        token = argv[i]

        if token == "--":
            positionals.extend(argv[i + 1 :])
            break

        if not token.startswith("-") or token == "-":
            # non-option argument: GNU getopt permutes it to the end
            positionals.append(token)
            i += 1
            continue

        if token.startswith("--"):
            # long option, possibly abbreviated, possibly --name=arg
            body = token[2:]
            if "=" in body:
                name, _, inline_arg = body.partition("=")
                has_inline = True
            else:
                name, inline_arg, has_inline = body, None, False

            exact = [lo for lo in longopts if lo.name == name]
            if exact:
                matches = exact
            else:
                matches = [lo for lo in longopts if lo.name.startswith(name)]

            if not matches:
                err(f"unrecognized option '{token}'")
                return options, positionals, True
            if len(matches) > 1:
                possibilities = " ".join(f"'--{lo.name}'" for lo in matches)
                err(f"option '{token}' is ambiguous; possibilities: {possibilities}")
                return options, positionals, True

            match = matches[0]
            if match.has_arg == NO_ARGUMENT:
                if has_inline:
                    err(f"option '--{match.name}' doesn't allow an argument")
                    return options, positionals, True
                options.append((match.val, None))
            else:
                if has_inline:
                    options.append((match.val, inline_arg))
                elif i + 1 < n:
                    i += 1
                    options.append((match.val, argv[i]))
                else:
                    err(f"option '--{match.name}' requires an argument")
                    return options, positionals, True
            i += 1
            continue

        # short option cluster
        j = 1
        while j < len(token):
            opt_char = token[j]
            spec_pos = shortopts.find(opt_char)
            if spec_pos < 0 or opt_char == ":":
                err(f"invalid option -- '{opt_char}'")
                return options, positionals, True
            takes_arg = spec_pos + 1 < len(shortopts) and shortopts[spec_pos + 1] == ":"
            if takes_arg:
                if j + 1 < len(token):
                    options.append((opt_char, token[j + 1 :]))
                elif i + 1 < n:
                    i += 1
                    options.append((opt_char, argv[i]))
                else:
                    err(f"option requires an argument -- '{opt_char}'")
                    return options, positionals, True
                break
            options.append((opt_char, None))
            j += 1
        i += 1

    return options, positionals, False
