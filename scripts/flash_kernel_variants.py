"""Build variants of the row-attention kernels' wgmma design and compare them
on a CUDA card: what ptxas and the SASS say (registers, spills, wgmma
serialisation) and how fast each runs at the paths' shapes.

    python3 scripts/flash_kernel_variants.py [variant ...]

A variant is a set of text substitutions on the sources under
npe_pfn_tpu_torch/ops/csrc/ (see VARIANTS); each is copied to a temporary
directory, built with the port's nvcc flags and timed in a process of its
own, and the first variant is timed again at the end for the spread. Per
variant it prints the ptxas performance warnings, per wgmma kernel the
highest register the SASS names and its spill (STL/LDL), HGMMA and
WARPGROUP.DEPBAR counts (one DEPBAR per HGMMA means the chain is
serialised), then the forward at B 25 x 2048 x 2048, the lse forward and the
backward at B 264 x 768 x 768 and 128 x 768 (ms, CUDA events), each with its
error against the plain version. It imports nothing of JAX.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "npe_pfn_tpu_torch", "ops", "csrc")
FWD, BWD = "flash_row_attention.cu", "flash_row_attention_bwd.cu"

_BN = "constexpr int BN = 64;  // keys per tile (64 or 128)"
VARIANTS = {
    "shipped": [],
    "fwd_bn128_s3": [(FWD, _BN, "constexpr int BN = 128;"),
                     (FWD, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "fwd_bn64_s3": [(FWD, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "bwd_s3": [(BWD, "constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}


def make(name, root):
    """Copy the sources under root/<name>/csrc with the variant's edits."""
    d = os.path.join(root, name)
    shutil.copytree(CSRC, os.path.join(d, "csrc"))
    for source, old, new in VARIANTS[name]:
        path = os.path.join(d, "csrc", source)
        text = open(path).read()
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in {source}")
        open(path, "w").write(text.replace(old, new))
    return d


def sass_facts(library):
    """Per wgmma kernel of a built library: highest register, STL, LDL, HGMMA
    and WARPGROUP.DEPBAR counts, from cuobjdump -sass."""
    from npe_pfn_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    facts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "2wg" in m.group(1) else None
            if name:
                facts[name] = dict(maxreg=0, STL=0, LDL=0, HGMMA=0, DEPBAR=0)
            continue
        if name is None:
            continue
        f = facts[name]
        for r in re.findall(r"\bR(\d+)\b", line):
            f["maxreg"] = max(f["maxreg"], int(r))
        for key, op in (("STL", "STL"), ("LDL", "LDL"), ("HGMMA", "HGMMA"),
                        ("DEPBAR", "WARPGROUP.DEPBAR")):
            f[key] += op in line
    return facts


def cuda_ms(fn, iters=30):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(name, d):
    import torch

    from npe_pfn_tpu_torch.ops import _build

    _build.CSRC_DIR = type(_build.CSRC_DIR)(os.path.join(d, "csrc"))
    _build.BUILD_DIR = type(_build.BUILD_DIR)(os.path.join(d, "build"))
    from npe_pfn_tpu_torch.ops import flash_attention as fa

    for source in (FWD, BWD):
        path, seconds, log = _build.build(source)
        warnings = sorted({line.split(":", 2)[2].strip()[:90] for line in log.splitlines()
                           if "(C75" in line})
        print(f"[{name}] {source}: nvcc {seconds:.1f} s; ptxas warnings {warnings}")
        for kernel, f in sass_facts(str(path)).items():
            short = re.search(r"2wg\d+(\w+?)E", kernel).group(1)
            print(f"[{name}]   {short}: {f}")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, k, v = randn(25, 2048, 2, 128), randn(25, 2048, 2, 128), randn(25, 2048, 2, 128)
    m = torch.ones(2048, dtype=torch.bool, device="cuda")
    err = (fa.flash_row_attention(q, k, v, m).float()
           - fa.reference_row_attention(q, k, v, m)).abs().max().item()
    out = [f"forward B25 2048x2048 {cuda_ms(lambda: fa.flash_row_attention(q, k, v, m)):.4f} ms "
           f"(max abs err {err:.1e})"]
    for lq in (768, 128):
        q, d_out = randn(264, lq, 2, 128), randn(264, lq, 2, 128)
        k, v = randn(264, 768, 2, 128), randn(264, 768, 2, 128)
        m = torch.ones(264, 768, dtype=torch.bool, device="cuda")
        o, lse = fa.flash_row_attention_lse(q, k, v, m)
        grads = fa.flash_row_attention_bwd(q, k, v, m, o, lse, d_out)
        refs = fa.reference_row_attention_bwd(q, k, v, m, o, lse, d_out)
        rel = max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                  for g, r in zip(grads, refs))
        fwd_ms = cuda_ms(lambda: fa.flash_row_attention_lse(q, k, v, m))
        bwd_ms = cuda_ms(lambda: fa.flash_row_attention_bwd(q, k, v, m, o, lse, d_out))
        out.append(f"B264 {lq}x768: lse forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms "
                   f"(gradient rel err {rel:.1e})")
    print(f"[{name}] " + "; ".join(out), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        return run(sys.argv[2], sys.argv[3])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    with tempfile.TemporaryDirectory() as root:
        dirs = {n: make(n, root) for n in names}
        for n in names + names[:1]:
            rc = subprocess.run([sys.executable, __file__, "--one", n, dirs[n]], timeout=600)
            if rc.returncode:
                print(f"[{n}] failed, exit {rc.returncode}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
