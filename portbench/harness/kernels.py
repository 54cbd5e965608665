"""The port's attention kernels told apart in a trace, by the template
arguments of their demangled names (`tracing.template_args`) and by their
launch grid: the launches of kernel 10 (`flash_sdpa_window_qkv`,
`csrc/window_attn.cu`) and of kernel 9 (`flash_sdpa_bnhd`,
`csrc/onepass_attn.cu`).

Both entries launch the templates of `csrc/attn_mma.cuh`:
  attn_mma::attn_kernel<DP, SPLIT, MODE, NW, STAGES>
  attn_mma::attn_wg_kernel<DP, NWG, SPLIT, MODE>
on a grid of (query tiles x key splits, heads, batch), and after a split
key range attn_mma::merge_kernel. MODE is kPlain (0) or kWindow (2).
  - Kernel 10 never splits (SPLIT false, no merge). It launches MODE
    kWindow over the packed qkv as one batch element, except where its
    windows are whole 128-row blocks (Hiera-L's stage-3 windows of
    16 x 16 = 256 tokens): there it launches kernel 9's plain tile (MODE
    kPlain) with the windows as the batch, so grid z = the windows, more
    than one, since the program's gate sends only blocks of several
    windows to it.
  - Kernel 9 launches MODE kPlain with the image batch as grid z: one image
    a request in every cell, so grid z = 1; with a split key range (D over
    128) SPLIT true and merge_kernel after it.
So a MODE kPlain launch belongs to kernel 10 over several batch elements
and to kernel 9 over one. `tests/test_portbench_kernel_share.py` holds
these names and values to the CUDA sources.
"""
from portbench.harness.tracing import template_args

__all__ = ["ATTN", "MERGE", "K_PLAIN", "K_WINDOW", "attn_params",
           "window_qkv", "bnhd"]

ATTN = {"attn_mma::attn_kernel": ("DP", "SPLIT", "MODE", "NW", "STAGES"),
        "attn_mma::attn_wg_kernel": ("DP", "NWG", "SPLIT", "MODE")}
MERGE = "attn_mma::merge_kernel"
K_PLAIN, K_WINDOW = "0", "2"


def attn_params(name):
    """{parameter: argument} of an attention tile's demangled name, or
    None for another kernel."""
    base, args = template_args(name)
    params = ATTN.get(base)
    if params is None or len(args) != len(params):
        return None
    return dict(zip(params, args))


def window_qkv(name, grid):
    """Whether a launch is kernel 10's."""
    p = attn_params(name)
    if p is None or p["SPLIT"] != "false":
        return False
    return p["MODE"] == K_WINDOW or (
        p["MODE"] == K_PLAIN and len(grid) == 3 and grid[2] > 1)


def bnhd(name, grid):
    """Whether a launch is kernel 9's (one image a launch)."""
    if template_args(name)[0] == MERGE:
        return True
    p = attn_params(name)
    return (p is not None and p["MODE"] == K_PLAIN and len(grid) == 3
            and grid[2] == 1)
