#!/usr/bin/env python3
"""Times the block-sparse kernels B5, B5s, B6d, B6s and B6b (or, with
--kernels local, the localized B1, B1p and B2; with --kernels global, the
global-bank B3, B3' and B4) of one checkout on one NVIDIA GPU.

    python3 chip_b6_variants.py [--checkout DIR] [--profile] [--variants]
    python3 chip_b6_variants.py --kernels local [--checkout DIR] [--profile]
    python3 chip_b6_variants.py --kernels global [--checkout DIR] [--profile]
                                [--variants]

From the repo root, on a machine with a card. DIR (default: this
checkout) is any checkout of the repo, such as an earlier commit unpacked
with `git archive` into the git-ignored `_archive/`; its own chip_smoke.py
and gtos_tpu_torch are imported, so its kernels run with its own wrappers,
and two checkouts are compared by running the script on each in one call
on the card (parent, this tree, this tree, parent). The script serves the
fullest c5 batch of each node bucket and trains the c5 model as
chip_smoke's c5 phase does, and captures the main path's inputs: layer 0's
B5 inputs of each served batch, and layer 0's B5s and B6 inputs of
CAPTURE_BATCHES train batches. It runs chip_smoke's check_b5 (B5 on the
served inputs, B5s on the train inputs) and check_b6 on them, and all of
them on BLOCK_CASES in f32 and bf16: each kernel against its plain
version (B6: the same bits twice), timed (CUDA events, L2 flushed, mean
of 30 after 3 warm-ups) beside its bound. It prints one JSON line: each
kernel's mean ms over the main-path inputs and its ms on each BLOCK_CASES
shape. With --profile (a checkout whose chip_smoke profiles a given
batch), torch.profiler over one more c5 train step on each captured batch
first: device busy time, idle share and each block-sparse (`blk_*`)
kernel's share of device time. With --variants (this checkout's kernels
only), the sources are built once more with GTOS_B5_VARIANTS and
GTOS_B6_VARIANTS, which add four (pairs a lane group holds, blocks an SM)
variants of the bf16 kernels for rows up to 64 wide (B5/B5s; B6d, B6s and
B6b); each is forced in turn and timed on the bf16 inputs, each result
held against the plain versions; the last line gives each variant's mean
over the main-path inputs.

With --kernels local the same for the c2 model under "pallas_local":
chip_smoke's serving and training phases, then layer 0's B1 inputs of
each served batch and B1p/B2 inputs of CAPTURE_BATCHES train batches
(`capture_b1_inputs`, `capture_train_inputs`), each kernel checked and
timed on them (`phase_main_shapes`) and on the N=32 and N=128 probes of
`phase_kernels` in f32 and bf16; one JSON line of the means; then B2's
time per kernel on each train input (torch.profiler). --profile: this
script's checkout's `phase_profile_train` (the shares of B1p, B2 and of
any copy of the bank halves a/b) over one more train step of the other
checkout on each captured batch.

With --kernels global the same for the c2 model under "pallas": chip_smoke's
"pallas" serving and training phases, layer 0's B3/B3' inputs of each
served batch and B3/B3'/B4 inputs of CAPTURE_BATCHES train batches of each
bank (`capture_global_inputs`), each kernel checked and timed on them
(`phase_global_shapes`) and on `phase_kernels`' N=32 and N=128 probes
(P=2048 and 4096) in f32 and bf16; one JSON line of the means; then B4's
time per kernel on each train input (torch.profiler) beside the time of
writing its two dense tables alone (two torch zero_, `time_ms`), and B4's
`time_ms` at several spins (SPIN_STUDY); beside them the `time_ms` of one
empty kernel (`torch.cuda._sleep(0)`), the timer's floor for one launch.
With --variants (this checkout's kernels only), the forward source is built
once more with GTOS_B3_VARIANTS, which lets B3 take 2, 4 or 8 pairs a lane
group a round for rows up to 64 wide; each is forced in turn on B3's
main-path inputs and the P=4096 probes in both types, held against the
plain version and timed; the last line gives each design's mean over the
main-path inputs.
--profile: this script's checkout's
`phase_profile_train` (B3's, B3''s and B4's shares) over one more train
step of the other checkout on each captured batch (all B3', the card's
rule).

Every mode sets the checkout's `time_ms` spin (`set_spin`) to this
script's checkout's, so that two checkouts are timed with the same spin.
This script loads its own chip_smoke beside the checkout's, which imports
utils/benchlib.py from the checkout's package: DIR is a checkout that has
that module.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

KERNELS = ("B5", "B5s", "B6d", "B6s", "B6b")
HERE = Path(__file__).resolve().parent
SPIN_STUDY = (200_000, 1_000_000, 4_000_000)   # time_ms spins, cycles


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--kernels", choices=("block", "local", "global"),
                    default="block")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve()))

    import torch

    import chip_smoke as cs
    from gtos_tpu_torch.models import Generator

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "card")
    checkout = str(Path(cs.__file__).resolve().parent)
    set_spin(cs, this_chip_smoke().SPIN_CYCLES)
    print(cs.card_line(), flush=True)
    print(f"[b6] checkout {checkout}; time_ms spin {cs.SPIN_CYCLES} cycles",
          flush=True)
    if args.kernels == "local":
        main_local(cs, checkout, args)
        return
    if args.kernels == "global":
        main_global(cs, checkout, args)
        return
    cfg, _ = cs.c5_configs()
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    serve_inputs = cs.phase_c5_serve(cfg, model, cs.c5_corpus()[1][0])[3]
    del model
    trained = cs.phase_c5_train()
    trainer, batches = trained[:2]
    inputs = cs.capture_block_train_inputs(trainer,
                                           batches[:cs.CAPTURE_BATCHES])
    if args.profile:
        for i, batch in enumerate(batches[:cs.CAPTURE_BATCHES]):
            cs.phase_profile_train(trainer, trained[3], batch=batch,
                                   label=f"c5 block_sparse train step {i + 1}")
    del trainer
    torch.cuda.empty_cache()
    main_ms = {name: [] for name in KERNELS}
    variant_cases = []
    for i, fwd_args in enumerate(serve_inputs):
        main_ms["B5"].append(cs.check_b5(f"serve{i}", fwd_args)["ms"])
        variant_cases.append((f"serve{i}", fwd_args, None, None))
    for i, (fwd_args, src, bwd) in enumerate(inputs):
        main_ms["B5s"].append(
            cs.check_b5(f"train{i}", fwd_args, with_stats=True)["ms"])
        rows = cs.check_b6(f"train{i}", fwd_args, src, bwd=bwd)
        for name in ("B6d", "B6s", "B6b"):
            main_ms[name].append(rows[name]["ms"])
        variant_cases.append((f"train{i}", fwd_args, src, bwd))
    cases_ms = {}
    for name, spec in cs.BLOCK_CASES.items():
        batch = cs.block_batch(*spec)
        for dtype in (torch.float32, torch.bfloat16):
            fwd_args, src, g = cs.block_inputs(batch, 8, 64, dtype)
            row = {"B5": cs.check_b5(name, fwd_args)["ms"],
                   "B5s": cs.check_b5(name, fwd_args, with_stats=True)["ms"]}
            row.update({k: v["ms"] for k, v in
                        cs.check_b6(name, fwd_args, src, g).items()})
            cases_ms[f"{name} {cs._dtype_name(fwd_args[0])}"] = row
            if dtype == torch.bfloat16:
                variant_cases.append((name, fwd_args, src,
                                      cs.b6_args(fwd_args, src, g)))
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": checkout, "main_path_mean_ms": {
        name: sum(ms) / len(ms) for name, ms in main_ms.items()},
        "cases_ms": cases_ms}), flush=True)
    if args.variants:
        time_variants(cs, variant_cases)


def time_variants(cs, cases):
    """Each forced bf16 variant of B5/B5s and of B6d/B6s/B6b on the bf16
    cases (serving inputs: B5 only), each result against the plain
    versions; prints the per-variant means over the main-path inputs as
    JSON."""
    import torch

    from gtos_tpu_torch.ops import block_sparse_attention as bsa
    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bm
    from gtos_tpu_torch.ops import build

    fwd, fwd_variant = bsa.fwd_entries(
        build.load(bsa.FWD_SOURCE, ("GTOS_B5_VARIANTS",)))
    entries = bm.kernel_entries(build.load(bm.BWD_SOURCE,
                                           ("GTOS_B6_VARIANTS",)))
    real = bsa._fwd_kernel, bm._bwd_kernels
    bsa._fwd_kernel, bm._bwd_kernels = (lambda: fwd), (lambda: entries)
    n = fwd_variant(-1)
    if n != entries[3](-1):
        cs.fail("the forward and backward sources hold different numbers "
                "of variants")
    means = {}
    try:
        for label, fwd_args, src, bwd in cases:
            t4 = bsa.bank_t4(fwd_args[3], fwd_args[4])
            kernels = {}
            if bwd is None:
                kernels["B5"] = (
                    lambda: bsa.block_sparse_attention(*fwd_args, t4=t4),
                    bsa.block_sparse_attention_reference(*fwd_args, t4=t4))
            else:
                (core, plan), ts, tr = bwd, fwd_args[5], fwd_args[6]
                ref_d = bm.block_sparse_attention_bwd_dst_reference(*core,
                                                                    ts, tr)
                kernels["B5s"] = (
                    lambda: bsa.block_sparse_attention_with_stats(
                        *fwd_args, t4=t4),
                    bsa.block_sparse_attention_with_stats_reference(
                        *fwd_args, t4=t4))
                dst = lambda: bm.block_sparse_attention_bwd_dst(  # noqa
                    *core, ts, tr, plan)
                E = ref_d[1].shape[1]    # B6d's ge is [H, E_cap]
                trim = lambda o: (o[0], o[1][:, :E])  # noqa: E731
                kernels["B6d"] = (lambda: trim(dst()), ref_d)
                pair_s = dst()[2]   # the same values under every variant
                kernels["B6s"] = (
                    lambda: bm.block_sparse_attention_bwd_src(
                        *core, *src, plan, pair_s),
                    bm.block_sparse_attention_bwd_src_reference(*core, *src))
                q, k, a, b = core[0], core[1], core[3], core[4]
                ge = ref_d[1].new_zeros(ref_d[1].shape[0], plan["cap"])
                ge[:, :E] = ref_d[1]
                kernels["B6b"] = (
                    lambda: bm.block_sparse_bank_grads(q, k, a, b, ge, plan),
                    bm.block_sparse_bank_grads_reference(q, k, a, b, ge,
                                                         plan))
            for v in range(n):
                fwd_variant(v)
                entries[3](v)
                for name, (fn, ref) in kernels.items():
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    cs._compare(name, f"{label} variant {v}", "bfloat16",
                                [(f"out{x}", y, z)
                                 for x, (y, z) in enumerate(zip(got, ref))])
                    ms = cs.time_ms(fn)
                    print(f"[variant] {label} variant {v}: {name} "
                          f"{ms:.6f} ms", flush=True)
                    if not label.startswith("N"):
                        means.setdefault(v, {}).setdefault(name, []).append(
                            ms)
            torch.cuda.empty_cache()
    finally:
        fwd_variant(-1)
        entries[3](-1)
        bsa._fwd_kernel, bm._bwd_kernels = real
    print(json.dumps({"main_path_mean_ms": {
        v: {name: sum(ms) / len(ms) for name, ms in by.items()}
        for v, by in means.items()}}))


def set_spin(cs, cycles):
    """The spin before each call of the checkout's `time_ms`: its
    chip_smoke's own constant, or utils/benchlib.py's where its chip_smoke
    imports `time_ms` from there (this tree and later)."""
    cs.SPIN_CYCLES = cycles
    lib = sys.modules.get("gtos_tpu_torch.utils.benchlib")
    if lib is not None:
        lib.SPIN_CYCLES = cycles


def this_chip_smoke():
    """This script's own chip_smoke, loaded beside the checkout's (whose
    modules it then uses): its profile reports the localized kernels'
    shares for either checkout."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main_local(cs, checkout, args):
    """--kernels local: B1 on the c2 serving inputs, B1p and B2 on the c2
    train inputs, and all three on the N=32 and N=128 probes; then, after
    every timing (time_ms runs with no profiler), the train step profiles
    and B2's kernels one by one on the train inputs."""
    import torch

    from gtos_tpu_torch.ops import local_relation_attention as lra

    torch.backends.cuda.matmul.allow_tf32 = False
    _, model, _, batches, _, serve_launches = cs.phase_serve()
    b1_inputs = cs.capture_b1_inputs(model, batches)
    del model
    trainer, ms_step, train_launches, _ = cs.phase_train()
    train_batches = [b for _, b in zip(range(cs.CAPTURE_BATCHES),
                                       cs.train_loader())]
    train_inputs = cs.capture_train_inputs(trainer, train_batches)
    rows = cs.phase_main_shapes(b1_inputs, serve_launches, train_inputs,
                                train_launches)
    main_ms = {row["name"]: row["ms"] for row in rows}
    cases_ms = {}
    for name, batch in (("N32", cs.honest_batch(32, 0, 10, 31)),
                        ("N128", cs.honest_batch(8, 1, 64, 80))):
        for dtype in (torch.float32, torch.bfloat16):
            fwd = cs.kernel_inputs(batch, 8, 64, dtype)
            bwd = cs.b2_args(fwd)
            cases_ms[f"{name} {cs._dtype_name(fwd[0])}"] = {
                "B1": cs.check_b1(name, fwd)["ms"],
                "B1p": cs.check_b1p(name, fwd)["ms"],
                "B2": cs.check_b2(name, bwd, fwd[6])["ms"]}
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": checkout, "main_path_mean_ms": main_ms,
                      "cases_ms": cases_ms}), flush=True)
    if args.profile:
        here = this_chip_smoke()
        for i, batch in enumerate(train_batches):
            here.phase_profile_train(
                trainer, ms_step, batch=batch,
                label=f"c2 pallas_local train step {i + 1}")
    for i, (_, bwd) in enumerate(train_inputs):
        kernels = kernel_breakdown(lambda: lra.local_relation_attention_bwd(
            *bwd[:10], **({"runs": bwd[10]} if len(bwd) > 10 else {})))
        print(f"[b2] train{i}: B2's kernels, mean device ms of 10 calls, L2 "
              f"flushed: {json.dumps(kernels)}", flush=True)


def main_global(cs, checkout, args):
    """--kernels global: B3/B3' on the c2 "pallas" serving inputs, B3/B3'
    and B4 on its train inputs, and all three on the N=32 and N=128
    probes; then, after every timing (time_ms runs with no profiler), the
    train step profiles, B4's kernels one by one on the train inputs and
    B4's time_ms on one train input at each spin of SPIN_STUDY."""
    import torch

    from gtos_tpu_torch.ops import relation_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    _, model, _, batches, _, serve_launches = cs.phase_serve("pallas")
    serve_inputs = cs.capture_global_inputs(model, batches, train=False)
    del model
    trainer, ms_step, train_launches, train_batches = cs.phase_train(
        "pallas")
    captured = (train_batches[:cs.CAPTURE_BATCHES]
                + train_batches[-cs.CAPTURE_BATCHES:])
    train_inputs = cs.capture_global_inputs(trainer.model, captured,
                                            train=True)
    rows = cs.phase_global_shapes(serve_inputs, serve_launches, train_inputs,
                                  train_launches)
    main_ms = {row["name"]: row["ms"] for row in rows}
    # B3's main-path inputs: the tables of the B3' inputs (the card's rule
    # routes every bank to B3')
    variant_cases = [(f"{tag}{i}", cs.table_args(args) if kind == cs.B3I
                      else args)
                     for tag, captured in (("serve", serve_inputs),
                                           ("train", train_inputs))
                     for i, (kind, args, _) in enumerate(captured)]
    cases_ms = {}
    for name, spec in (("N32_P2048", (16, 0, 10, 14, 32, 2048)),
                       ("N32_P4096", (16, 0, 16, 20, 32, 4096)),
                       ("N128_P2048", (8, 1, 12, 18, 128, 2048)),
                       ("N128_P4096", (8, 1, 20, 30, 128, 4096))):
        batch = cs.global_batch(*spec)
        for dtype in (torch.float32, torch.bfloat16):
            fwd = cs.global_inputs(batch, 8, 64, dtype)
            targs = cs.table_args(fwd)
            cases_ms[f"{name} {cs._dtype_name(fwd[0])}"] = {
                "B3": cs.check_b3(name, targs)["ms"],
                "B3'": cs.check_b3i(name, fwd)["ms"],
                "B4": cs.check_b4(name, cs.b4_args(targs))["ms"]}
            if name.endswith("P4096"):
                variant_cases.append(
                    (f"{name} {cs._dtype_name(fwd[0])}", targs))
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": checkout, "main_path_mean_ms": main_ms,
                      "cases_ms": cases_ms}), flush=True)
    print(f"[b3] one empty kernel (torch.cuda._sleep(0)) under time_ms: "
          f"{cs.time_ms(lambda: torch.cuda._sleep(0)):.6f} ms", flush=True)
    if args.variants:
        time_b3_variants(cs, variant_cases)
    if args.profile:
        here = this_chip_smoke()
        for i, batch in enumerate(captured):
            here.phase_profile_train(
                trainer, ms_step, impl="pallas", batch=batch,
                label=f"c2 pallas train step {i + 1}")
    bwd = [b for _, _, b in train_inputs if b is not None]
    for i, args_b4 in enumerate(bwd):
        kernels = kernel_breakdown(
            lambda: ra.fused_relation_attention_bwd(*args_b4), key="rel_")
        q, t2 = args_b4[0], args_b4[4]
        tables = [torch.empty(q.shape[0], q.shape[2], q.shape[1],
                              t2.shape[-1], dtype=t2.dtype, device="cuda")
                  for _ in range(2)]
        write_ms = cs.time_ms(lambda: [t.zero_() for t in tables])
        print(f"[b4] train{i}: B4's kernels, mean device ms of 10 calls, L2 "
              f"flushed: {json.dumps(kernels)} (sum "
              f"{sum(kernels.values()):.6f}); writing its two dense tables "
              f"alone (two zero_, time_ms) {write_ms:.6f} ms", flush=True)
        del tables
    spin = cs.SPIN_CYCLES
    try:
        for cycles in SPIN_STUDY:
            set_spin(cs, cycles)
            ms = cs.time_ms(lambda: ra.fused_relation_attention_bwd(*bwd[0]))
            print(f"[b4] train0: time_ms with a {cycles}-cycle spin "
                  f"{ms:.6f} ms", flush=True)
    finally:
        set_spin(cs, spin)


def time_b3_variants(cs, cases):
    """Each of B3's designs for rows up to 64 wide (the source built with
    GTOS_B3_VARIANTS) forced in turn on `cases` (label, B3's arguments):
    held against the plain version (`_hold`) and timed; prints the
    per-design means over the main-path inputs as JSON."""
    import torch

    from gtos_tpu_torch.ops import build
    from gtos_tpu_torch.ops import relation_attention as ra

    tables, inline, variant = ra.fwd_entries(
        build.load(ra.FWD_SOURCE, ("GTOS_B3_VARIANTS",)))
    real = ra._fwd_kernels
    ra._fwd_kernels = lambda: (tables, inline)
    means = {}
    try:
        for v in range(variant(-1)):
            variant(v)
            for label, targs in cases:
                ref = ra.fused_relation_attention_reference(*targs)
                got = ra.fused_relation_attention(*targs)
                torch.cuda.synchronize()
                cs._hold("B3", f"{label} variant {v}",
                         cs._dtype_name(targs[0]), [("out", got, ref)])
                ms = cs.time_ms(lambda: ra.fused_relation_attention(*targs))
                print(f"[variant] B3 {label} variant {v}: {ms:.6f} ms",
                      flush=True)
                if not label.startswith("N"):
                    means.setdefault(v, []).append(ms)
    finally:
        variant(-1)
        ra._fwd_kernels = real
    print(json.dumps({"b3_main_path_mean_ms": {
        v: sum(ms) / len(ms) for v, ms in means.items()}}), flush=True)


def kernel_breakdown(fn, reps=10, key="local_"):
    """Mean device ms per call of each kernel `fn` launches whose name
    holds `key` (named from there), from torch.profiler over `reps` calls
    after one warm-up, the L2 flushed before each call as time_ms flushes
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key[e.key.index(key):].split("(")[0]:
            e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key}


if __name__ == "__main__":
    main()
