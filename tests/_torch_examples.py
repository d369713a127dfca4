"""Shared helpers of the example twins' tests (``repro_torch.examples``):
the reference's ``examples/<name>.py`` loaded by path, a ``main``'s standard
output captured, and two outputs compared line by line.

Both packages print the same lines from the same numbers. A printed float
may still differ in its last digit where the port's GNN logits differ from
the reference's in the 6th digit, so a line that is not equal must have the
same words and integers, and floats within one unit of their last printed
digit plus ``rtol`` of their value. Ids, groups and counts are integers:
they must be equal."""
import contextlib
import importlib.util
import io
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def reference_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def output_of(fn, *args) -> list[str]:
    """The lines ``fn(*args)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _same_line(want: str, got: str, rtol: float) -> bool:
    if want == got:
        return True
    if _NUM.sub("#", want) != _NUM.sub("#", got):
        return False
    for a, b in zip(_NUM.findall(want), _NUM.findall(got)):
        if "." not in a and "e" not in a:
            if a != b:
                return False
            continue
        places = len(a.split(".")[1].split("e")[0]) if "." in a else 0
        if abs(float(a) - float(b)) > 10.0 ** -places + rtol * abs(float(a)):
            return False
    return True


def assert_same_output(want: list[str], got: list[str], *, rtol: float = 1e-5,
                       wall_clock: tuple = ()) -> None:
    """``got`` prints what ``want`` prints, line by line. Lines that hold
    one of the ``wall_clock`` markers print a time or a rate of this run:
    they are left out on both sides, and each side must have them."""
    for marker in wall_clock:
        assert any(marker in l for l in want), marker
        assert any(marker in l for l in got), marker
    keep = lambda lines: [l for l in lines
                          if not any(m in l for m in wall_clock)]
    want, got = keep(want), keep(got)
    assert len(got) == len(want), (len(want), len(got),
                                   "\n".join(want), "\n".join(got))
    for i, (a, b) in enumerate(zip(want, got)):
        assert _same_line(a, b, rtol), f"line {i}:\n  reference {a!r}\n  port      {b!r}"
