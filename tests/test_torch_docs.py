r"""The port's documentation names only what exists.

Every dotted ``bblean_tpu_torch.<name>`` in ``docs/torch/*.md`` and in the
README's section on the port must resolve by import and ``getattr``, and
every ``bb-torch <command> --option`` named there (also as ``python -m
bblean_tpu_torch.cli``) must be a command of the port's parser with that
option, and a value given to an option with choices must be one of them.
"""

import argparse
import importlib
import re
import shlex
from pathlib import Path

import pytest

from bblean_tpu_torch.cli import _build_parser

ROOT = Path(__file__).resolve().parent.parent
PAGES = sorted((ROOT / "docs" / "torch").glob("*.md"))
README_SECTION = "## PyTorch + CUDA port"
DOTTED = re.compile(r"\bbblean_tpu_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+")
COMMAND = re.compile(r"(?:\bbb-torch|-m bblean_tpu_torch\.cli)((?:[ \t]+[^\s`#]+)*)")


def _text(name: str) -> str:
    if name != "README.md":
        return (ROOT / "docs" / "torch" / name).read_text()
    text = (ROOT / "README.md").read_text()
    start = text.index(README_SECTION)
    end = text.find("\n## ", start + len(README_SECTION))
    return text[start:] if end < 0 else text[start:end]


DOCS = [p.name for p in PAGES] + ["README.md"]


def test_the_pages_exist() -> None:
    assert {p.name for p in PAGES} == {
        "index.md", "installing.md", "user-guide.md", "parameters.md",
        "api-reference.md", "gpu-memory.md",
    }


def _resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


@pytest.mark.parametrize("doc", DOCS)
def test_every_dotted_name_resolves(doc: str) -> None:
    names = sorted(set(DOTTED.findall(_text(doc))))
    assert names, f"{doc} names nothing of bblean_tpu_torch"
    missing = []
    for name in names:
        try:
            _resolve(name)
        except (ImportError, AttributeError):
            missing.append(name)
    assert not missing, f"{doc}: {missing}"


def _snippets(text: str) -> list[str]:
    r"""The lines of fenced blocks and the inline code spans (which may
    break across lines), each as one line."""
    fenced = re.findall(r"^```[^\n]*\n(.*?)^```", text, flags=re.M | re.S)
    rest = re.sub(r"^```[^\n]*\n.*?^```", "", text, flags=re.M | re.S)
    lines = [ln.split(" #")[0] for block in fenced for ln in block.splitlines()]
    spans = [" ".join(s.split()) for s in re.findall(r"`([^`]+)`", rest)]
    return lines + spans


def _parsers() -> dict[str, argparse.ArgumentParser]:
    parser = _build_parser()
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {"": parser, **sub.choices}


def _command_faults(tokens: list[str], parsers: dict) -> list[str]:
    name = "" if not tokens or tokens[0].startswith("-") else tokens[0]
    if name not in parsers:
        return [f"no command {name!r}"]
    actions = parsers[name]._option_string_actions
    faults = []
    for i, tok in enumerate(tokens):
        if not tok.startswith("-") or tok == "-":
            continue
        opt = tok.split("=")[0]
        if opt not in actions:
            faults.append(f"{name}: no option {opt}")
            continue
        choices = actions[opt].choices
        value = tok.split("=", 1)[1] if "=" in tok else (
            tokens[i + 1] if i + 1 < len(tokens) else None
        )
        if choices and value and not value.startswith("-"):
            faults += [f"{name} {opt}: no choice {v}" for v in value.split("|") if v not in choices]
    return faults


@pytest.mark.parametrize("doc", DOCS)
def test_every_command_and_option_parses(doc: str) -> None:
    parsers = _parsers()
    seen, faults = 0, []
    for snippet in _snippets(_text(doc)):
        for match in COMMAND.finditer(snippet):
            tokens = shlex.split(match.group(1))
            if not tokens:
                continue  # the script's name alone
            seen += 1
            faults += [f"{snippet!r}: {f}" for f in _command_faults(tokens, parsers)]
    assert not faults, faults
    if doc in ("installing.md", "user-guide.md", "api-reference.md", "README.md"):
        assert seen, f"{doc} names no bb-torch command"
