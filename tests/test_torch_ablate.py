"""The ablation harness of the tiled kernels (utils/ablate.py) on the CPU:
every edit still applies to the kernel source, once, inside its kernel, and
the harness refuses to measure without a CUDA card."""

import pytest
import torch

from fesom2_accelerate_tpu_torch.ops.cuda import build
from fesom2_accelerate_tpu_torch.utils import ablate

CASES = [(k, v) for k, vs in ablate.ABLATIONS.items() for v in vs]


@pytest.mark.parametrize("kernel,variant", CASES)
def test_edits_apply_once_inside_their_kernel(kernel, variant):
    src = (build.CSRC / ablate.SOURCE).read_text()
    out = ablate.edited_source(kernel, variant)
    start, end = ablate._body(src, kernel)
    # the text outside the kernel's body is untouched
    assert out.startswith(src[:start])
    assert out.endswith(src[end:])
    body = out[start:len(out) - (len(src) - end)]
    assert body != src[start:end]
    for old, new in ablate.ABLATIONS[kernel][variant]:
        assert " ".join(old.split()) not in " ".join(body.split())
        assert new in body


def test_an_edit_that_no_longer_matches_raises():
    src = (build.CSRC / ablate.SOURCE).read_text()
    drifted = src.replace("if (n >= N) return;", "if (n >= N) { return; }")
    with pytest.raises(ValueError, match="matches 0 times"):
        ablate.edited_source("update_fused", "edge_phase", drifted)
    # an edit outside the named kernel does not count as a match
    with pytest.raises(ValueError, match="matches 0 times"):
        ablate.edited_source("bounds", "no_gather", src.replace(
            "      lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;\n    }\n"
            "    for (int r = warp;",
            "      lev[k] = ok ? nd_lev[(size_t)n * KD + k] + 0 : 0;\n    }\n"
            "    for (int r = warp;"))


def test_launching_from_restores_the_library():
    sentinel = object()
    with pytest.raises(RuntimeError):
        with ablate.launching_from(sentinel):
            assert build.library() is sentinel
            raise RuntimeError("a failed measurement")
    # the cached loader is back, and was never called here
    assert build.library.cache_info().currsize == 0, \
        "the CPU tests must not build or load the CUDA library"


def test_measure_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA device"):
        ablate.main(["--preset", "toy"])
    assert build.library.cache_info().currsize == 0
