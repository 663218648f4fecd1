#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

  env      the card's name and power limit (nvidia-smi), torch and CUDA
           versions, TF32 switched off, the time to build the kernels from
           src/repro_torch/csrc with nvcc into build/kernels/ (one nvcc per
           source, all started together), and the HGMMA (wgmma)
           instructions of each kernel in the built libraries' SASS.
  kernels  every kernel of the paths (flash attention, SSD scan, KV-page
           pack and unpack) against its plain torch version on the card, at
           the serving shapes (flash also at qwen3-moe's 64/4 heads of 128
           and seamless-m4t's decoder, 16/16 heads of 64) and the
           reference's edge shapes, with times and bounds at the serving
           shapes. The KV-page kernels are held bit for bit, and their
           index checks must raise.
  kv_path  the KV-page kernels' own entry points (`kv_pack`, `kv_unpack`),
           which no other path of the system runs: qwen2-0.5b's per-layer
           K|V pages gathered from one pool on the card into a transfer
           buffer and scattered into a second pool.
  serve    one phase per model, full width, random f32 weights from a seed,
           served disaggregated: kernel prefill on node 0, the decode cache
           shipped through the TENT engine across a rail flap, greedy
           decode on node 1; checked against an unshipped decode, a plain
           prefill (use_pallas=False) and the replay-prefill entry point.
             qwen2-0.5b   B=4, 1024-token prompts (flash attention)
             mamba2-370m  B=4, 1024-token prompts (SSD scan)
             hymba-1.5b   B=2, 3072-token prompts, window 2048 (both)
             qwen3-moe-235b-a22b  B=4, 1024-token prompts, depth 94 cut to
                          2 (flash; 128 experts, top 8, sorted dispatch);
                          a route pick that differs between the kernel and
                          the plain prefill is reported with its
                          probability gap, and the batch rows it reaches
                          are left out of the 2e-3 check
             seamless-m4t-medium  B=4, 1024-token prompts, 256 encoder
                          frames from the seed (flash in the decoder's 12
                          layers; the encoder's 12 run plain)
  serve_bf16  qwen2-0.5b, mamba2-370m and qwen3-moe-235b-a22b (depth 4)
           the same way in bfloat16, the reference's default parameter type
           (flash attention and the SSD scan on the tensor cores), each
           prefill held against an f32 evaluation of the same bf16 weights
           (layer by layer) no further than 1.5x the plain bf16 prefill is.
  profile  device time by op (torch.profiler) over one prefill and eight
           decode steps of each serve phase, and the device's busy share.
  sharded  right after the qwen3-moe f32 serve phase, its model (full
           width, depth 2, its own parameters wrapped as DTensors of the
           sharding rules' placements) under `activation_sharding` on the
           host mesh (1, 1) over a one-rank NCCL group: the sharded prefill
           (flash on local shards under `local_map`, 2 launches;
           `moe_ffn_ep` expert-parallel in both layers) against the
           unsharded one within 2e-3, 4 decode steps from a copy of its
           cache likewise, `moe_ffn_ep` alone at T = 4096 and 4 against
           `moe_ffn_sorted` within 1e-4; the collectives by kind; prefill,
           decode-step and MoE-FFN ms with and without the mesh.
  train    the training path (`repro_torch.training`) at full width and
           depth: qwen2-0.5b's 494,032,768 params in bf16 with fp32
           moments and per-layer remat, B=4 x 1024 tokens from
           SyntheticTokens(seed=0), 8 AdamW steps (warmup 1) through
           `make_train_step`, plain attention (no kernel has a backward
           pass; none may launch). Every loss and grad norm finite, the
           mean of the last 3 losses below the first 3's, step 0's loss
           equal to `loss_fn` under no_grad within 1e-6; step ms (CUDA
           events), tokens/s, peak memory, and one step profiled (busy
           share, top kernels). Then remat on against off at full width,
           depth 4, f32 (loss and every gradient within 1e-5), and one f32
           step of the smoke model on the card against the CPU (loss
           within 1e-5, params within 2 lr).
  rl_update  the trained params through TENT to 16 ranks: `flatten_state`
           (988,065,536 bytes), `CheckpointEngine(nodes=2, gpus_per_node=8)`
           over checkpoint_broadcast with rails (0, 1) and (0, 5) at 25 %
           (the reference example's fabric), round_robin then tent, each
           `update(verify=True)`; tent no slower than round_robin (the
           scenario's tent_vs_baseline). The weights rebuilt from the 16
           ranks' segments equal the trainer's bit for bit, and a bf16 flash
           prefill (B=4, 1024 tokens) on them equals the same prefill on the
           trainer's tensors and differs from step 0's (its 24 flash
           launches are the path's); an npz round trip through
           `save_checkpoint`/`load_checkpoint`, bit for bit.
  moe_layer  qwen3-moe-235b-a22b's MoE FFN (`moe_ffn_sorted`) alone at full
           width, at the prefill's T = 4096 and decode's T = 4, f32 and
           bf16: CUDA-event and device times of the layer, of routing, of
           the expert products and of the combine (the dispatch is the
           rest), device time by kernel, beside its bounds.
  hicache  three-tier HiCache (GPU/CPU/disk pools of real bytes) for the
           full-width qwen2-0.5b on the disagg_prefill_decode engine: two
           4096-token conversations, the second demoting the first, which
           is then fetched back up; the promoted bytes must be those inserted.
  scenarios  the scenario runner over the 25-scenario library with its
           declared expectations (host work on the virtual clock); one line
           per scenario, and any violation fails the run.
  jit_core the engine's jitted core on the card (`EngineConfig.jit_core`):
           its main path, a zero-jitter transfer of 64 slices over 8 rails
           with the crossover forced to 1, must launch the chooser
           (`tent_choose_wave_padded`) once and the drain
           (`tent_on_complete_many`) 16 times; both held bit for bit
           against their torch twins on the card and the numpy twins on
           randomized padded inputs at buckets 8-1024, at the chooser's
           seam between its one-warp kernel (up to 32 candidates) and its
           block kernel (1, 31, 32 and 33 candidates), an all-excluded
           wave and padding rows; the drain on its live entries through
           the path's staged call (in place on the mapped staging buffer)
           and the public `complete_many` on card buffers, also at the
           main path's 64 x 8, at m = 1, with every completion on one
           slot, at 2048 slots (eight blocks) and at 5000 live of a
           bucket of 8192 (five shared tiles), the scratch row kept as
           gathered; the staging A/B on a line of its own (`drain_ab`:
           the path's call against a copy in, launch and copy back); the
           13 library scenarios in which a kernel
           engages, with jit_core on,
           equal their jit-off reports (the tests run all 25 on the CPU),
           also with the crossover forced to 1 on three; a recorded run
           turns the jitted core off with a warning and changes nothing;
           times of both kernels, their plain versions, the numpy twins
           and the adapter's round trip at buckets 32, 256 and 1024 (the
           drain's kernel also at a fixed depth of 8 over those sizes),
           taken before the sweep's worker processes start; the 13 scenarios'
           walls with jit_core off and on, taken after they end.
  mc_sweep the Monte Carlo sweep (`MonteCarloSweep`, the `spray_sim`
           kernel, a thread group a seed lane) over the five scenarios of
           BENCH_mc.json at 64 seeds and fault_jitter 0.25: every lane equal
           to the plain torch sim on the card, seeds 0 and 1 equal to the
           numpy twin (both in worker processes, which time nothing that is
           reported), single_rail_flap's report equal to the CPU's, each
           report ok, tent's throughput P50 within 2 % of BENCH_mc.json's;
           the eight other sweepable library programs, 3 lanes each under
           both policies, equal to the numpy twin; each launch plan.
           Then, the workers ended: the flap's tent lanes against the plain
           sim and one numpy lane, each timed; the five sweeps again, timed,
           with the draws timed apart, their reports byte-equal to the
           first pass's; a 4096-seed flap_storm sweep timed beside the
           plain sim on the card, and its kernel alone.

  dryrun   `python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b`
           for each of 4 input shapes x the 16x16 and 2x16x16 meshes, one
           subprocess a case (one process holds one default group), all 8
           started together: meta tensors under fake groups of 256 and 512
           ranks, host work only; each must exit 0 and every case's bytes
           a device must equal the reference's; its FLOPs, collective
           bytes, roofline terms and seconds are printed.
  lint     the port's static checks on this machine: tentlint
           (`repro_torch.analysis.lint --strict`) over the package's Python
           and CUDA sources, the tests, this script and the kernel probe
           must exit 0; the rule's reading of each library's sources and
           nvcc flags (`rules.cuda_builds`) must equal what this run loaded
           (`kernels.build.loaded_builds`), for all five libraries; and
           single_rail_flap through the port's scenario runner under the
           runtime sanitizer (`sanitized()`) must report no violation.

Then a {"kernels": [...]} summary and, last, {"ok": true, "device": ...}.
Any failed check raises and the script exits non-zero. Without a card it
exits non-zero before printing anything. It needs one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.analysis import lint as tentlint  # noqa: E402
from repro_torch.analysis.core import Project, iter_source_files  # noqa: E402
from repro_torch.analysis.rules import cuda_builds  # noqa: E402
from repro_torch.analysis.sanitize import sanitized  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import EngineConfig, Fabric, FabricSpec, TelemetryStore, TentEngine  # noqa: E402
from repro_torch.core import Topology, jit_core  # noqa: E402
from repro_torch.core.jit_core import (  # noqa: E402
    EngineJitCore,
    _bucket,
    make_draws,
    simulate_spray_ref,
    stack_draws,
)
from repro_torch.core.scheduler import (  # noqa: E402
    tent_choose_wave,
    tent_choose_wave_padded_torch,
    tent_on_complete_many_torch,
)
from repro_torch.core.topology import LinkDesc  # noqa: E402
from repro_torch.core.types import LinkClass, Location, MemoryKind  # noqa: E402
from repro_torch.kernels.build import loaded_builds  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.kv_pack import kv_pack, kv_pack_ref, kv_unpack, kv_unpack_ref  # noqa: E402
from repro_torch.kernels.kv_pack import kernel as kv_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.spray_sim import kernel as sim_kernel  # noqa: E402
from repro_torch.kernels.spray_sim import spray_sim, spray_sim_ref  # noqa: E402
from repro_torch.kernels.tent_core import kernel as tc_kernel  # noqa: E402
from repro_torch.kernels.tent_core import ops as tc_ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import decode_step, init_params, loss_fn, prefill_forward  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402
from repro_torch.obs import FlightRecorder  # noqa: E402
from repro_torch.obs import events as OBS  # noqa: E402
from repro_torch.obs.explain import replay_wave  # noqa: E402
from repro_torch.scenarios import FaultEvent, MonteCarloSweep, ScenarioRunner, get, names  # noqa: E402
from repro_torch.scenarios.sweep import SWEEP_POLICIES, compile_spray_program  # noqa: E402
from repro_torch.sharding.ctx import activation_sharding  # noqa: E402
from repro_torch.sharding.rules import batch_spec, param_shardings, placements  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CheckpointEngine,
    DisaggregatedServer,
    HiCache,
    bytes_to_tree,
    greedy_decode,
    kv_bytes_per_token,
    make_cpu_pool,
    make_disk_pool,
    make_gpu_pool,
    monolithic_generate,
    tree_to_bytes,
)
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    SyntheticTokens,
    flatten_state,
    init_opt_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    unflatten_like,
)
from repro_torch.training.tree import named_leaves, tree_leaves, tree_map  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # CUDA cores, TF32 off
PEAK_F64 = 34e12  # CUDA cores
HBM_BPS = 3.35e12

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}  # tests/test_kernels.py:14-15
SERVE_SHAPE = (4, 1024, 14, 2, 64)  # (B, S, H, K, D): qwen2-0.5b prefill below
QWEN3_MOE_FLASH_SHAPE = (4, 1024, 64, 4, 128)  # qwen3-moe-235b-a22b prefill below
SEAMLESS_FLASH_SHAPE = (4, 1024, 16, 16, 64)  # seamless-m4t-medium decoder prefill below
HYMBA_FLASH_SHAPE, HYMBA_WINDOW = (2, 3072, 25, 5, 64), 2048  # hymba-1.5b prefill
# the reference's edge shapes, and S = 200 with D = 128 (not a multiple of
# the 64-key tile, the wide head's two column halves)
EDGE_SHAPES = [(1, 200, 4, 2, 64), (1, 128, 4, 1, 128), (2, 256, 8, 2, 64), (1, 200, 4, 1, 128)]
# head dims the kernel takes zero-padded: qwen2-0.5b-smoke's 56 (to 64), and 80 (to 128)
PADDED_HEAD_SHAPES = [(2, 256, 8, 2, 56), (1, 200, 4, 2, 56), (1, 200, 4, 1, 80)]
WINDOW_SHAPE = (1, 256, 4, 2, 64)  # windows 16 (inside one kv tile) and 64
# SSD scan: (B, S, H, P, N, chunk)
SSD_SERVE_SHAPE = (4, 1024, 32, 64, 128, 128)  # mamba2-370m prefill below
SSD_HYMBA_SHAPE = (2, 3072, 50, 64, 16, 128)  # hymba-1.5b prefill below
SSD_TAIL_SHAPES = [(2, 100, 32, 64, 128, 128), (1, 200, 50, 64, 16, 128)]
# short prompts: S = 5 takes chunk 8 and S = 40 chunk 64 (the wrapper's rule)
SSD_SHORT_SHAPES = [(2, 5, 32, 64, 128, 128), (2, 40, 50, 64, 16, 128)]
SSD_STATE_SHAPE = (2, 256, 8, 64, 128, 64)
# B and C rows 2N + 3 elements apart: not a multiple of 16 bytes in either type
SSD_MISALIGNED_SHAPE, SSD_MISALIGNED_PAD = (2, 300, 8, 64, 128, 128), 3
# the reference's own test shapes (tests/test_kernels.py:73-75 and :97), and
# P = 128, which the wrapper splits into two kernel calls of 64 columns
SSD_REF_SHAPES = [(1, 128, 2, 16, 32, 32), (1, 100, 2, 16, 32, 32), (1, 128, 2, 32, 64, 128),
                  (2, 256, 4, 128, 64, 64)]
# KV pages: (num_pages, page_size, kv_dim, n). The reference's test shapes,
# ragged rows (kv_dim 3; page size 5 takes the 2-byte path in bf16), one
# page, and the whole pool in reverse order.
KV_CHECK_SHAPES = [(32, 16, 128, 8), (64, 8, 256, 64), (40, 16, 3, 7), (40, 5, 3, 9),
                   (33, 16, 128, 1), (64, 8, 256, "reverse")]
# serving geometry, pool and buffer both far larger than the 50 MB L2:
# qwen2-0.5b's per-layer K|V page (16 tokens x 2 kv heads x 64 x K,V) and
# hymba-1.5b's (16 x 5 x 64 x 2)
KV_QWEN2 = (131072, 16, 256, 8192)
KV_HYMBA = (32768, 16, 640, 4096)

# (arch, batch, prompt, new tokens, parameter type, depth: None for the
# published one); replay checks on 256-token prompts. qwen3-moe's 94 layers
# hold 2.49e9 parameters each (9.95 GB in f32), so its depth is cut to what
# one 80 GB card holds beside the checks; its width is not.
SERVES = [("qwen2-0.5b", 4, 1024, 32, torch.float32, None),
          ("mamba2-370m", 4, 1024, 32, torch.float32, None),
          ("hymba-1.5b", 2, 3072, 32, torch.float32, None),
          ("qwen2-0.5b", 4, 1024, 32, torch.bfloat16, None),
          ("mamba2-370m", 4, 1024, 32, torch.bfloat16, None),
          ("qwen3-moe-235b-a22b", 4, 1024, 32, torch.float32, 2),
          ("qwen3-moe-235b-a22b", 4, 1024, 32, torch.bfloat16, 4),
          ("seamless-m4t-medium", 4, 1024, 32, torch.float32, None)]
# enc-dec: encoder frames = prompt // 4, as the reference's dry run sizes
# them (src/repro/launch/dryrun.py:151)
ENC_FRAMES_DIV = 4
MOE_ARCH, MOE_TOKENS = "qwen3-moe-235b-a22b", (4096, 4)  # moe_layer: prefill and decode T
# sharded: the qwen3-moe f32 serve phase's model under the host mesh, its
# decode steps, and moe_ffn_ep alone at these T (capacities 320 and 1)
SHARDED_ARCH, SHARDED_DECODE, SHARDED_MOE_TOL = "qwen3-moe-235b-a22b", 4, 1e-4
# dryrun: the reference's `_analytic_bytes` per device for qwen3-moe-235b-a22b
# (src/repro/launch/dryrun.py:256 on the 16x16 and 2x16x16 meshes)
DRYRUN_ARCH, DRYRUN_TIMEOUT_S = "qwen3-moe-235b-a22b", 600
DRYRUN_BYTES = {("train_4k", "16x16"): 9_219_932_164, ("train_4k", "2x16x16"): 9_219_932_164,
                ("prefill_32k", "16x16"): 1_843_986_432, ("prefill_32k", "2x16x16"): 1_843_986_432,
                ("decode_32k", "16x16"): 4_998_103_040, ("decode_32k", "2x16x16"): 3_421_044_736,
                ("long_500k", "16x16"): 1_942_552_576, ("long_500k", "2x16x16"): 1_942_552_576}
# a bf16 kernel prefill's logits may lie at most this many times as far from
# an f32 evaluation of the same bf16 weights as the plain bf16 prefill's do
BF16_GATE = 1.5
REPLAY_PROMPT, REPLAY_NEW = 256, 16
SEED = 0
# train: qwen2-0.5b at full width and depth (494,032,768 params, bf16, fp32
# moments, remat full), B x S tokens from SyntheticTokens(seed=0) a step;
# step TRAIN_PROFILED runs under the profiler and is left out of the mean
TRAIN_ARCH, TRAIN_PARAMS = "qwen2-0.5b", 494_032_768
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILED = 4, 1024, 8, 4
REMAT_DEPTH = 4  # remat on against off, full width, f32
# rl_update: the reference example's fabric (examples/rl_weight_update.py:
# 26-33), 2 nodes x 8 GPUs with rails (node, nic) degraded to 25 %, and a
# bf16 flash prefill on the refreshed weights
RL_NODES, RL_GPUS, RL_DEGRADED = 2, 8, ((0, 1), (0, 5))
RL_PREFILL_BATCH, RL_PREFILL_LEN = 4, 1024
# HiCache: full-width qwen2-0.5b pages of 64 tokens (786,432 bytes) in the
# reference example's three tiers, scaled to these pages
HICACHE_TIERS, HICACHE_PAGE_TOKENS, HICACHE_CONVO = (64, 128, 256), 64, 4096

# lint: the libraries whose flags tentlint reads and this run loads, and
# the scenario run under the runtime sanitizer
LINT_LIBRARIES = ("flash_attention", "ssd_scan", "kv_pack", "tent_core", "spray_sim")
SANITIZED_SCENARIO = "single_rail_flap"
# kernel name -> (module, launch-count attribute)
COUNTERS = {"flash_attention": (fa_kernel, "launches"), "ssd_scan": (ssd_kernel, "launches"),
            "kv_pack": (kv_kernel, "pack_launches"), "kv_unpack": (kv_kernel, "unpack_launches"),
            "tent_choose_wave_padded": (tc_kernel, "choose_launches"),
            "tent_on_complete_many": (tc_kernel, "drain_launches"),
            "spray_sim": (sim_kernel, "launches")}
LIBRARIES = (fa_kernel, ssd_kernel, kv_kernel, tc_kernel, sim_kernel)
NO_LAUNCHES = {name: 0 for name in COUNTERS}
# the jitted core and the sweep: where their checks run (the card)
DEV = "cuda"
FORCED_CROSSOVER = ("single_rail_flap", "elephant_mice_mix", "degrade_recover_ramp")
# the library scenarios in which an engine kernel engages with the default
# crossover (the chooser: 4-48 launches each; the drain in none), where the
# jit-on pass runs on the card. The other twelve launch nothing, so the card
# would run their numpy path twice; the CPU tests run all 25 with jit_core on.
JIT_ENGAGING = ("ascend_ub_kv", "checkpoint_broadcast", "elephant_mice_mix",
                "hetero_bandwidth_rails", "hicache_serve", "mnnvl_rack_kv",
                "multi_tenant_contention", "numa_skew_incast", "serving_checkpoint_overlap",
                "serving_closed_loop_flap", "serving_pd_handoff_incast",
                "trainer_broadcast_fanout", "uniform_spray")
JIT_BUCKETS = (32, 256, 1024)  # adapter round trip against the numpy path
MC_SCENARIOS = ("single_rail_flap", "flap_storm", "correlated_outage", "degrade_recover_ramp",
                "disagg_prefill_decode")  # the five of BENCH_mc.json
MC_SEEDS, MC_JITTER, MC_NUMPY_SEEDS, MC_BAND = 64, 0.25, (0, 1), 0.02
MC_BIG, MC_BIG_SCENARIO = 4096, "flap_storm"
# the sweepable library programs outside BENCH_mc.json's five: every lane of
# MC_OTHER_SEEDS held against the numpy twin under both policies
MC_OTHER = ("numa_skew_incast", "hetero_bandwidth_rails", "multi_tenant_contention",
            "elephant_mice_mix", "serving_production_stream", "mnnvl_rack_kv", "ascend_ub_kv",
            "uniform_spray")
MC_OTHER_SEEDS = 3
# the wave chooser's seam between its warp kernel (pc <= 32) and its block
# kernel: candidates padded to pc = 8, 32, 32 and 64, at these slice counts
CHOOSE_SEAM = (1, 31, 32, 33)
CHOOSE_SEAM_SLICES = (1, 31, 32, 33, 64, 100)
# worker processes of the mc_sweep phase: the plain sim on the card (one
# process a sweep; it is bound by its host dispatch) and the numpy twin
MC_WORKERS = 7
# the SSD scan's kernels in profiler names: ssd_chunk_state, ssd_state_pass,
# ssd_chunk_scan, and in f32 ssd_chunk_cb
SSD_PREFIX = "ssd_"
FLASH_NAME = "flash_fwd"  # flash_fwd_f32, flash_fwd_bf16
# the wave chooser's kernels: tent_choose_wave_warp (pc <= 32) and
# tent_choose_wave_padded (the block kernel)
CHOOSE_NAME = "tent_choose_wave"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, iters: int = 10, match: str = "") -> dict:
    """Device time of one call of `fn` by kernel name, from torch.profiler
    (CUPTI), no host time: {kernel: (ms per call, records)}. The profiler's
    schedule spends a first step of `iters` calls warming its tracing up
    and records the second. CUPTI returns fewer records than launches, at
    random and for any kernel (on one H100, windows of 10 launches of one
    kernel came back with 10, 4, 1 or no records), so a kernel's time is the
    mean over the records returned, times the launches a call makes of it
    (its records over `iters`, rounded, at least 1), and `records` says how
    many there were; a window with no record is tried again, up to three
    times. With `match`, only the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count and match in e.key
                and not e.key.startswith("ProfilerStep")]
        if rows:
            break
    return {e.key: (e.self_device_time_total / 1e3 / e.count * max(1, round(e.count / iters)),
                    e.count) for e in rows}


def device_ms(fn, match: str, iters: int = 10) -> tuple:
    """Device time of one call of `fn` and the profiler records it rests on:
    the kernels whose name holds `match` summed ("" takes every kernel, for
    a library call). The time is None when the profiler returned no such
    record: a time not measured prints as null, never as 0."""
    by_kernel = device_ms_by_kernel(fn, iters, match)
    if not by_kernel:
        return None, 0
    return sum(ms for ms, _ in by_kernel.values()), sum(n for _, n in by_kernel.values())


def _device_fields(fn, match: str, iters: int = 10) -> dict:
    ms, records = device_ms(fn, match, iters)
    return {"kernel_device_ms": ms, "kernel_device_records": records,
            "kernel_device_launches": iters}


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bound(flops, nbytes, dtype):
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(B, S, H, K, D, dtype, window=0):
    """Least time for causal attention on these inputs: 4*D flops per live
    (query, key) pair against q, k, v, o moved once. Returns (ms, bound_by)."""
    q = np.arange(S)
    live = q + 1 if window <= 0 else np.minimum(q + 1, window)
    flops = 4.0 * D * float(live.sum()) * B * H
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * torch.finfo(dtype).bits // 8
    return _bound(flops, nbytes, dtype)


def ssd_bound(B, S, H, P, N, chunk, dtype, with_state=False):
    """Least time for the SSD scan on these inputs, each product counted
    once: C B^T once per (batch, chunk) over its causal half (2N flops per
    pair i >= j), the intra-chunk product over the causal half (2P per pair
    and head), C state^T and the state update (2 L P N each per batch, head
    and chunk), for the S steps the data has (a ragged last chunk counts
    its own length). Bytes: x, a, B, C (and the fp32 initial state) read
    once, y and the fp32 final state written once. Returns (ms, bound_by)."""
    lens = [min(chunk, S - t0) for t0 in range(0, S, chunk)]
    pairs = sum(n * (n + 1) / 2 for n in lens)
    flops = B * (2 * N * pairs + H * (2 * P * pairs + 4.0 * S * P * N))
    el = torch.finfo(dtype).bits // 8
    nbytes = el * (2 * B * S * H * P + B * S * H + 2 * B * S * N) + 4 * B * H * P * N * (
        2 if with_state else 1)
    return _bound(flops, nbytes, dtype)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sass_hgmma(lib_path) -> dict:
    """HGMMA (wgmma) instructions per kernel in a built library's SASS, by
    cuobjdump from the toolkit that built it; kernels named as in the
    source, with their template argument."""
    from repro_torch.kernels.build import _nvcc

    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"\d((?:ssd|flash)_\w+?)(?:ILi(\d+)E|E)", mangled)
            func = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")) if m else mangled
            counts[func] = 0
        elif func and "HGMMA" in line:
            counts[func] += 1
    return counts


# --------------------------------------------------------------------------- env
def phase_env() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, in parallel
        list(pool.map(lambda mod: mod.load(), LIBRARIES))
    build_s = time.perf_counter() - t0
    env = {
        "phase": "env",
        "nvidia_smi": card,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "kernel_build_s": build_s,
        "sass_hgmma": {name: sass_hgmma(mod.load()._name)
                       for name, mod in (("flash_attention", fa_kernel), ("ssd_scan", ssd_kernel))},
    }
    emit(env)
    idle = [k for lib in env["sass_hgmma"].values() for k, n in lib.items() if "bf16" in k and not n]
    if idle:
        raise AssertionError(f"bf16 kernels without wgmma (no HGMMA in their SASS): {idle}")
    return env


# ----------------------------------------------------------------------- kernels
def _agree(name, out, ref, dtype):
    if out.dtype != ref.dtype or out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: bad output {out.dtype} {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    return bool((err <= tol + tol * ref.float().abs()).all()), err.max().item()


def _qkv(shape, dtype, seed):
    B, S, H, K, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D)


def _check_case(shape, dtype, window, seed):
    q, k, v = _qkv(shape, dtype, seed)
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    ok, err = _agree(f"flash attention {shape} {dtype}", out, ref, dtype)
    case = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "window": window, "max_abs_err": err, "tol": TOL[dtype]}
    if not ok:
        raise AssertionError(f"flash attention disagrees with its plain version: {case}")
    return case, (q, k, v)


def _ssd_inputs(shape, dtype, seed, with_state=False, bc_pad=8):
    """x (B,S,H,P) scaled by 0.5, a = -0.3|N(0,1)|, and B, C as strided
    slices of one (B, S, 2N + bc_pad) tensor, as the model slices them out
    of its projection; the reference's kernel-test scales."""
    B, S, H, P, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, S, H, P, generator=g, device="cuda") * 0.5).to(dtype)
    a = (-torch.randn(B, S, H, generator=g, device="cuda").abs() * 0.3).to(dtype)
    bc = (torch.randn(B, S, 2 * N + bc_pad, generator=g, device="cuda") * 0.5).to(dtype)
    s0 = torch.randn(B, H, P, N, generator=g, device="cuda") if with_state else None
    return x, a, bc[..., :N], bc[..., N:2 * N], s0


def _check_ssd(shape, dtype, seed, with_state=False, bc_pad=8):
    x, a, Bm, Cm, s0 = _ssd_inputs(shape, dtype, seed, with_state, bc_pad)
    y, fin = ssd_chunked(x, a, Bm, Cm, chunk=shape[5], initial_state=s0)
    y_ref, fin_ref = ssd_scan_ref(x, a, Bm, Cm, s0)
    torch.cuda.synchronize()
    ok_y, err_y = _agree(f"ssd scan y {shape} {dtype}", y, y_ref, dtype)
    ok_s, err_s = _agree(f"ssd scan state {shape} {dtype}", fin, fin_ref.to(dtype), dtype)
    case = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "initial_state": with_state, "bc_row_stride": Bm.stride(1),
            "max_abs_err": max(err_y, err_s),
            "y_max_abs_err": err_y, "state_max_abs_err": err_s, "tol": TOL[dtype]}
    if not (ok_y and ok_s):
        raise AssertionError(f"ssd scan disagrees with its plain version: {case}")
    return case, (x, a, Bm, Cm, s0)


def _check_ssd_mixed(shape, seed):
    """bfloat16 x with float32 a, B and C (the reference casts each input on
    its own): the wrapper widens them all to float32 for the kernel and
    returns y in x's type."""
    x, a, Bm, Cm, _ = _ssd_inputs(shape, torch.float32, seed)
    x = x.to(torch.bfloat16)
    y, fin = ssd_chunked(x, a, Bm, Cm, chunk=shape[5])
    y_ref, fin_ref = ssd_scan_ref(x, a, Bm, Cm)
    torch.cuda.synchronize()
    ok_y, err_y = _agree(f"ssd scan mixed y {shape}", y, y_ref, torch.bfloat16)
    ok_s, err_s = _agree(f"ssd scan mixed state {shape}", fin, fin_ref.to(torch.bfloat16),
                         torch.bfloat16)
    case = {"shape": list(shape), "dtype": "bfloat16", "mixed": "x bfloat16, a/B/C float32",
            "max_abs_err": max(err_y, err_s), "tol": TOL[torch.bfloat16]}
    if not (ok_y and ok_s):
        raise AssertionError(f"ssd scan on mixed types disagrees with its plain version: {case}")
    return case


def _flash_timing(shape, dtype, case, window=0):
    q, k, v = _qkv(shape, dtype, seed=1)
    B, S, H, K, D = shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, bound_by = flash_bound(B, S, H, K, D, dtype, window)
    if window:
        # SDPA has no window argument: the causal band goes in as a boolean mask
        pos = torch.arange(S, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    # not gated: how far the library call is from the plain version
    lib_err = (library().transpose(1, 2).float()
               - flash_attention_ref(q, k, v, causal=True, window=window).float()).abs().max()
    kernel = lambda: flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
    # ms: back-to-back calls through the public wrapper, host work included
    # (CUDA events); device_ms: the kernels alone (profiler)
    dev, records = device_ms(kernel, FLASH_NAME)
    lib_dev, lib_records = device_ms(library, "")
    return {
        "shape": list(shape), "window": window, "kernel_ms": cuda_ms(kernel),
        "kernel_device_ms": dev, "kernel_device_records": records,
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=window),
                            iters=5),
        "library_ms": cuda_ms(library), "library_device_ms": lib_dev,
        "library_device_records": lib_records,
        "library_max_abs_err": lib_err.item(),
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"],
    }


def _ssd_name(key: str) -> str:
    return re.search(r"ssd_\w+(?:<\d+>)?", key).group(0)


def _ssd_timing(shape, dtype, case, inputs):
    x, a, Bm, Cm, _ = inputs
    bound, bound_by = ssd_bound(*shape, dtype)
    kernel = lambda: ssd_chunked(x, a, Bm, Cm, chunk=shape[5])  # noqa: E731
    # ms: back-to-back calls through the public wrapper (CUDA events);
    # device_ms: the SSD kernels alone (profiler), summed and one by one
    by_kernel = device_ms_by_kernel(kernel, match=SSD_PREFIX)
    return {
        "shape": list(shape),
        "kernel_ms": cuda_ms(kernel),
        "kernel_device_ms": sum(ms for ms, _ in by_kernel.values()) if by_kernel else None,
        "kernel_device_ms_by_kernel": {_ssd_name(k): ms for k, (ms, _) in by_kernel.items()},
        "kernel_device_records": {_ssd_name(k): n for k, (_, n) in by_kernel.items()},
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(x, a, Bm, Cm), iters=2, warmup=1),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"],
    }


def kv_bound(n, page_bytes):
    """Least time for moving n pages: each moved page read once and written
    once, and the n int32 indices read once, at the card's memory rate; no
    arithmetic. Returns (ms, bound_by)."""
    return (2 * n * page_bytes + 4 * n) / HBM_BPS * 1e3, "bytes"


def _kv_pool(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _kv_indices(num_pages, n, gen):
    """n distinct random pages (all pages in reverse for n="reverse"), int32."""
    if n == "reverse":
        return torch.arange(num_pages - 1, -1, -1, device="cuda", dtype=torch.int32)
    return torch.randperm(num_pages, generator=gen, device="cuda")[:n].int()


def _check_kv(shape, dtype, seed):
    """Pack and unpack against their plain versions, bit for bit: the
    gathered buffer, the scattered pool, unpack in place (same storage,
    pages it does not name untouched), and a pack -> unpack round trip."""
    num_pages, page, dim, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = _kv_pool((num_pages, page, dim), dtype, g)
    idx = _kv_indices(num_pages, n, g)
    buf = kv_pack(pool, idx)
    want = kv_pack_ref(pool, idx)
    dst = _kv_pool((num_pages, page, dim), dtype, g)
    before, ptr = dst.clone(), dst.data_ptr()
    out = kv_unpack(dst, buf, idx)
    want_dst = kv_unpack_ref(before.clone(), buf, idx)
    restored = kv_unpack(torch.zeros_like(pool), kv_pack(pool, idx), idx)
    torch.cuda.synchronize()
    untouched = torch.ones(num_pages, dtype=torch.bool, device="cuda")
    untouched[idx.long()] = False
    checks = {
        "pack_equal": torch.equal(buf, want),
        "unpack_equal": torch.equal(out, want_dst),
        "unpack_in_place": out is dst and dst.data_ptr() == ptr,
        "untouched_pages_equal": torch.equal(dst[untouched], before[untouched]),
        "round_trip_equal": torch.equal(restored[idx.long()], pool[idx.long()]),
    }
    case = {"shape": [num_pages, page, dim, idx.numel()], "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": max((buf.float() - want.float()).abs().max().item(),
                               (out.float() - want_dst.float()).abs().max().item()),
            **checks}
    if not all(checks.values()):
        raise AssertionError(f"KV-page kernels disagree with their plain versions: {case}")
    return case


def _check_kv_refusals(dtype) -> dict:
    """A page named twice raises ValueError and an index outside the pool
    IndexError, for both kernels, and the pool is left as it was."""
    g = torch.Generator(device="cuda").manual_seed(9)
    pool = _kv_pool((16, 16, 128), dtype, g)
    before = pool.clone()
    seen = {}
    for label, bad, err in (("repeated", [3, 5, 3], ValueError), ("past_end", [2, 16], IndexError),
                            ("negative", [-1, 4], IndexError)):
        idx = torch.tensor(bad, device="cuda")
        buf = _kv_pool((len(bad), 16, 128), dtype, g)
        for name, call in (("kv_pack", lambda: kv_pack(pool, idx)),
                           ("kv_unpack", lambda: kv_unpack(pool, buf, idx))):
            try:
                call()
            except err:
                seen[f"{name}_{label}"] = err.__name__
            else:
                raise AssertionError(f"{name} took {label} indices {bad} without raising")
    torch.cuda.synchronize()
    if not torch.equal(pool, before):
        raise AssertionError("a refused KV-page call changed the pool")
    return seen


def _kv_timing(shape, dtype, case):
    """Kernel entry (indices already int32 on the card), the public wrapper
    (with its index checks), and the plain version (one torch indexing call,
    which is also the library yardstick), at a serving geometry."""
    num_pages, page, dim, n = shape
    g = torch.Generator(device="cuda").manual_seed(11)
    pool = _kv_pool((num_pages, page, dim), dtype, g)
    idx = _kv_indices(num_pages, n, g)
    buf = kv_kernel.kv_pack(pool, idx)
    bound, bound_by = kv_bound(n, page * dim * pool.element_size())
    res = {}
    for name, kern, wrapper, plain in (
            ("kv_pack", lambda: kv_kernel.kv_pack(pool, idx), lambda: kv_pack(pool, idx),
             lambda: kv_pack_ref(pool, idx)),
            ("kv_unpack", lambda: kv_kernel.kv_unpack(pool, buf, idx),
             lambda: kv_unpack(pool, buf, idx), lambda: kv_unpack_ref(pool, buf, idx))):
        plain_ms = cuda_ms(plain)
        res[name] = {"shape": list(shape), "page_bytes": page * dim * pool.element_size(),
                     "kernel_ms": cuda_ms(kern), "wrapper_ms": cuda_ms(wrapper),
                     "plain_ms": plain_ms, "library_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by, "max_abs_err": case["max_abs_err"]}
    return res


def phase_kernels() -> dict:
    reset_launches()  # this phase's launches: checks and timing only
    fa_cases, ssd_cases, timing = [], [], {"flash_attention": {}, "ssd_scan": {}}
    kv_cases, timing["kv_pack"], timing["kv_unpack"], refusals = [], {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        case, _ = _check_case(SERVE_SHAPE, dtype, 0, seed=1)
        fa_cases.append(case)
        timing["flash_attention"][dt] = _flash_timing(SERVE_SHAPE, dtype, case)
        case, _ = _check_case(HYMBA_FLASH_SHAPE, dtype, HYMBA_WINDOW, seed=1)
        fa_cases.append(case)
        timing["flash_attention"][f"{dt}_hymba"] = _flash_timing(
            HYMBA_FLASH_SHAPE, dtype, case, HYMBA_WINDOW)
        for key, shape in (("qwen3_moe", QWEN3_MOE_FLASH_SHAPE),
                           ("seamless", SEAMLESS_FLASH_SHAPE)):
            case, _ = _check_case(shape, dtype, 0, seed=1)
            fa_cases.append(case)
            timing["flash_attention"][f"{dt}_{key}"] = _flash_timing(shape, dtype, case)
        for shape in (SSD_SERVE_SHAPE, SSD_HYMBA_SHAPE):
            case, inputs = _check_ssd(shape, dtype, seed=4)
            ssd_cases.append(case)
            key = dt if shape == SSD_SERVE_SHAPE else f"{dt}_hymba"
            timing["ssd_scan"][key] = _ssd_timing(shape, dtype, case, inputs)
            del inputs
        for shape in SSD_TAIL_SHAPES + SSD_SHORT_SHAPES:
            ssd_cases.append(_check_ssd(shape, dtype, seed=5)[0])
        ssd_cases.append(_check_ssd(SSD_STATE_SHAPE, dtype, seed=6, with_state=True)[0])
        ssd_cases.append(_check_ssd(SSD_MISALIGNED_SHAPE, dtype, seed=7,
                                    bc_pad=SSD_MISALIGNED_PAD)[0])
        for i, shape in enumerate(KV_CHECK_SHAPES):
            kv_cases.append(_check_kv(shape, dtype, seed=20 + i))
        refusals[dt] = _check_kv_refusals(dtype)
        geometries = [("", KV_QWEN2)] + ([("_hymba", KV_HYMBA)] if dtype == torch.bfloat16 else [])
        for suffix, shape in geometries:
            case = _check_kv(shape, dtype, seed=30)
            kv_cases.append(case)
            for name, row in _kv_timing(shape, dtype, case).items():
                timing[name][f"{dt}{suffix}"] = row
    for shape in EDGE_SHAPES + PADDED_HEAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            fa_cases.append(_check_case(shape, dtype, 0, seed=2)[0])
    for shape in SSD_REF_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            ssd_cases.append(_check_ssd(shape, dtype, seed=8)[0])
        ssd_cases.append(_check_ssd_mixed(shape, seed=9))
    for window in (16, 64):
        for dtype in (torch.float32, torch.bfloat16):
            fa_cases.append(_check_case(WINDOW_SHAPE, dtype, window, seed=3)[0])
    checks = read_launches()
    checked = []
    for name, cases in (("flash_attention", fa_cases), ("ssd_scan", ssd_cases),
                        ("kv_pack", kv_cases), ("kv_unpack", kv_cases)):
        checked.append({"name": name, "check_launches": checks[name], "cases": len(cases),
                        "max_abs_err": {dt: max(c["max_abs_err"] for c in cases
                                                if c["dtype"] == dt)
                                        for dt in ("float32", "bfloat16")}})
    res = {"phase": "kernels", "checked": checked, "timing": timing, "kv_refusals": refusals,
           "cases": {"flash_attention": fa_cases, "ssd_scan": ssd_cases, "kv_pages": kv_cases}}
    emit(res)
    return res


# ----------------------------------------------------------------------- kv_path
def phase_kv_path() -> dict:
    """The KV-page kernels' main path, their own entry points: qwen2-0.5b's
    per-layer K|V pages (f32, as the serve phases run) named by a host-side
    page table, gathered from a pool on the card into a transfer buffer and
    scattered into a second pool; every count is set to 0 just before."""
    num_pages, page, dim, n = KV_QWEN2
    g = torch.Generator(device="cuda").manual_seed(SEED)
    src = _kv_pool((num_pages, page, dim), torch.float32, g)
    dst = torch.zeros_like(src)
    rng = np.random.default_rng(SEED)
    src_pages = rng.permutation(num_pages)[:n].astype(np.int32)
    dst_pages = rng.permutation(num_pages)[:n].astype(np.int64)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    buf = kv_pack(src, src_pages)
    out = kv_unpack(dst, buf, dst_pages)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    want = {**NO_LAUNCHES, "kv_pack": 1, "kv_unpack": 1}
    if launches != want:
        raise AssertionError(f"the KV-page path launched {launches}, expected {want}")

    moved = torch.equal(dst[torch.from_numpy(dst_pages).cuda()],
                        src[torch.from_numpy(src_pages).long().cuda()])
    rest = torch.ones(num_pages, dtype=torch.bool, device="cuda")
    rest[torch.from_numpy(dst_pages).cuda()] = False
    if not (out is dst and moved and not dst[rest].any()):
        raise AssertionError("the KV-page path did not move exactly the named pages")
    res = {"phase": "kv_path", "pool": [num_pages, page, dim], "pages": n,
           "bytes_moved": 2 * n * page * dim * 4, "wall_ms": wall, "launches": launches,
           "pages_equal": True}
    emit(res)
    return res


# ------------------------------------------------------------------------- serve
def build_engine() -> TentEngine:
    """The engine `ScenarioRunner.build_engine` makes for the
    disagg_prefill_decode scenario (its fabric, engine knobs, policy "tent"
    and seed), without the scenario's fault program: the rail flap is
    scheduled by the caller, over the KV flow."""
    spec = get("disagg_prefill_decode")
    return TentEngine(spec.topology.to_fabric_spec(),
                      config=spec.engine.to_engine_config("tent"), seed=spec.seed)


def _engine_counters(engine: TentEngine) -> dict:
    return {"waves": engine.waves, "slices_issued": engine.slices_issued,
            "slices_retried": engine.slices_retried}


def _close(name, got, want, tol=2e-3):
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"{name}: kernel prefill vs plain prefill max err {err.max().item()}")
    return err.max().item()


def decode_cache(cfg, cache: dict, max_len: int) -> dict:
    """A decode cache from a prefill cache, in new tensors (decoding writes
    into its cache): K/V of a cache without a window grow to `max_len`; a
    window's ring and the SSM leaves (which have no length axis) are copied
    as they are."""
    pad = cfg.sliding_window == 0
    return {name: F.pad(t, (0, 0, 0, 0, 0, max_len - t.shape[2]))
            if pad and name in ("k", "v") else t.clone() for name, t in cache.items()}


def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill: one per attention layer and one per
    Mamba2 layer; serving moves no KV pages through the page kernels."""
    has_attn = cfg.arch_type != "ssm"
    has_ssm = cfg.arch_type == "ssm" or cfg.hybrid
    return {**NO_LAUNCHES, "flash_attention": cfg.num_layers if has_attn else 0,
            "ssd_scan": cfg.num_layers if has_ssm else 0}


class _F32Stack:
    """A stacked layer leaf that hands out one layer at a time in float32.
    The model reads layer i of a stacked leaf as leaf[i]
    (`repro_torch.models.model._layer`), so an f32 evaluation of bf16
    weights holds one layer's f32 copy at a time (qwen3-moe's bf16 layers
    would take 9.66 GB each in f32)."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getitem__(self, i):
        return self.t[i].float()


def _as_f32(params):
    return {n: {k: _F32Stack(v) for k, v in t.items()} if n == "layers"
            else _as_f32(t) if isinstance(t, dict) else t.float() for n, t in params.items()}


def prefill_distances(cfg, params, prompts, logits, enc=None) -> tuple:
    """How far a prefill's last-token logits lie from an f32 evaluation of
    the same weights through the plain path (the yardstick), beside how far
    the plain prefill in the weights' own type lies from it: (kernel,
    plain), each a max-abs distance. For bf16 weights the second says how
    much the type alone moves the logits. `enc`: the enc-dec frames, if any."""
    enc = enc or {}
    plain_cfg = cfg.with_(use_pallas=False)
    want = prefill_forward(plain_cfg, _as_f32(params), prompts,
                           **{n: t.float() for n, t in enc.items()})[0]
    plain = prefill_forward(plain_cfg, params, prompts, **enc)[0]
    return ((logits.float() - want).abs().max().item(),
            (plain.float() - want).abs().max().item())


class RouteRecorder:
    """Inside a `with` block, records every call of the MoE layers' `route`
    (the router's input, its probabilities and its picks) by wrapping
    `repro_torch.models.moe.route`, which `moe_ffn_sorted` looks up at each
    call; the package is as it was after the block."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._route = moe_mod.route

        def recorded(x, router_w, k):
            out = self._route(x, router_w, k)
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
            self.calls.append({"x": x.detach().clone(), "probs": probs, "idx": out[1].clone()})
            return out

        moe_mod.route = recorded
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route


def _kept(idx, C, E):
    """Which (token, pick) pairs of `idx` (T, k) `moe_ffn_sorted` keeps at
    capacity C, in idx's layout."""
    order, _, keep = moe_mod.bucket_slots(idx, E, C)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return kept.reshape(idx.shape)


def route_flips(cfg, kernel_calls, plain_calls, seq):
    """The (layer, token) pairs whose route picks, or whose kept pairs,
    differ between the kernel and the plain prefill, layer by layer.
    Returns (flips, rows): for each, its probability gap between the k-th
    and (k+1)-th expert on the kernel path and how far the router's input
    for the token lies apart between the paths; `rows`, the batch rows a
    difference reaches. A difference in a row no earlier layer reached is
    `first`: its input agreed up to the paths' rounding, unless the row's
    router input lies outside 2e-3."""
    k, E = cfg.experts_per_token, cfg.num_experts
    flips, rows = [], set()
    for layer, (kc, pc) in enumerate(zip(kernel_calls, plain_calls)):
        ki, pi = kc["idx"], pc["idx"]
        C = moe_mod.capacity(cfg, ki.shape[0])
        kk, pk = _kept(ki, C, E), _kept(pi, C, E)
        picks = (ki.sort(1).values != pi.sort(1).values).any(1)
        kept = (torch.where(kk, ki, E).sort(1).values
                != torch.where(pk, pi, E).sort(1).values).any(1)
        reached = set()
        for t in torch.nonzero(picks | kept).flatten().tolist():
            top = kc["probs"][t].sort(descending=True).values
            xk, xp = kc["x"][t].float(), pc["x"][t].float()
            err = (xk - xp).abs()
            flips.append({"layer": layer, "token": t, "row": t // seq,
                          "picks_differ": bool(picks[t]), "first": t // seq not in rows,
                          "prob_gap": (top[k - 1] - top[k]).item(),
                          "router_input_max_abs_err": err.max().item(),
                          "router_input_within_2e-3": bool((err <= 2e-3 + 2e-3 * xp.abs()).all())})
            reached.add(t // seq)
        rows |= reached
    return flips, rows


def phase_serve(arch: str, batch: int, prompt_len: int, n_new: int, dtype=torch.float32,
                depth=None):
    """`depth`: the decoder layers kept of the published config (None: all);
    the width is the published one."""
    cfg = get_config(arch).with_(use_pallas=True, remat="none")
    reduced = {}
    if depth is not None:
        reduced["num_layers"] = [cfg.num_layers, depth]
        cfg = cfg.with_(num_layers=depth)
    max_len = prompt_len + n_new
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, dtype=dtype, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device="cuda")
    enc = {}
    if cfg.is_encdec:
        enc["enc_frames"] = torch.randn((batch, prompt_len // ENC_FRAMES_DIV, cfg.d_model),
                                        generator=gen, device="cuda").to(dtype)
    torch.cuda.synchronize()
    want = expected_launches(cfg)
    steps = {}

    # the main path: prefill, handoff, decode, with every count set to 0 here
    reset_launches()
    # 1. kernel prefill: one launch per layer of each kernel it runs
    (logits, kv), prefill_ms = wall_ms(lambda: prefill_forward(cfg, params, prompts, **enc))
    if read_launches() != want:
        raise AssertionError(f"{arch} prefill launched {read_launches()}, expected {want}")
    if logits.shape != (batch, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} prefill logits are not finite or misshapen")
    steps["prefill"] = {"wall_ms": prefill_ms, "launches": read_launches(),
                        "cache_shapes": {n: list(t.shape) for n, t in kv.items()}}

    # 2. the decode cache (K/V without a window padded to max_len)
    cache = decode_cache(cfg, kv, max_len)

    # 3. ship it through TENT, with a rail flap over the flow
    engine = build_engine()
    server = DisaggregatedServer(engine, cfg, params)

    def handoff():
        data, metas = tree_to_bytes(cache)
        t0 = engine.fabric.now
        flap = engine.topology.rdma_nic(0, 1)
        engine.fabric.schedule_failure(flap.link_id, at=t0 + 0.002, recover_at=t0 + 0.02)
        done = {}
        dst, _ = server.ship_kv_async(data, lambda r: done.setdefault("res", r))
        engine.run_until_idle()
        res = done["res"]
        if not res.ok:
            raise AssertionError(f"KV handoff failed: {res.error}")
        if not res.completed_at > t0 + 0.002:
            raise AssertionError("the rail flap did not overlap the KV flow")
        return bytes_to_tree(dst.read(0, data.size), cache), data.size, metas, res

    (shipped, kv_bytes, metas, res), handoff_ms = wall_ms(handoff)
    for name in cache:
        if not torch.equal(shipped[name], cache[name]):
            raise AssertionError(f"shipped cache[{name!r}] differs from the prefill's")
    steps["handoff"] = {"wall_ms": handoff_ms, "kv_bytes": kv_bytes, "metas": metas,
                        "kv_transfer_seconds": res.completed_at - res.submitted_at,
                        **_engine_counters(engine)}

    # 4. decode on node 1 from the shipped cache
    tokens, decode_ms = wall_ms(
        lambda: greedy_decode(cfg, params, shipped, logits, prompt_len, n_new))
    steps["decode"] = {"wall_ms": decode_ms, "tokens": n_new,
                       "decode_tok_s": batch * n_new / (decode_ms / 1e3)}
    # the main path ends here; the checks below launch the kernels again
    main_launches = read_launches()
    if main_launches != want:
        raise AssertionError(f"the {arch} main path launched {main_launches}, expected {want}")

    # 5. the same decode from the unshipped cache: identical tokens
    local_cache = decode_cache(cfg, kv, max_len)
    local, local_ms = wall_ms(
        lambda: greedy_decode(cfg, params, local_cache, logits, prompt_len, n_new))
    if not np.array_equal(tokens, local):
        raise AssertionError("shipped-cache tokens differ from unshipped-cache tokens")
    steps["unshipped_decode"] = {"tokens_equal": True, "wall_ms": local_ms,
                                 "decode_tok_s": batch * n_new / (local_ms / 1e3)}
    del shipped, local_cache, cache
    dt = str(dtype).removeprefix("torch.")
    if dtype != torch.float32:
        # 6'. accuracy, calibrated by the plain path in the same type
        kernel_dist, plain_dist = prefill_distances(cfg, params, prompts, logits, enc)
        steps["accuracy"] = {"kernel_logits_max_abs_dist": kernel_dist,
                             "plain_logits_max_abs_dist": plain_dist,
                             "ratio": kernel_dist / plain_dist if plain_dist else None,
                             "gate": BF16_GATE}
        if not (np.isfinite(kernel_dist) and kernel_dist <= BF16_GATE * plain_dist):
            raise AssertionError(f"{arch} {dt} kernel prefill is {kernel_dist} from the f32 "
                                 f"yardstick, more than {BF16_GATE}x the plain prefill's "
                                 f"{plain_dist}")
        out = {"phase": f"serve_{dt.replace('float', 'f')}", "arch": arch, "batch": batch,
               "prompt": prompt_len, "max_len": max_len, "new_tokens": n_new, "dtype": dt,
               "reduced": reduced, "main_path_launches": main_launches, "steps": steps}
        emit(out)
        return out, (cfg, params, prompts, enc)

    # 6. plain prefill: logits and every cache leaf within 2e-3 of the
    #    kernel's. MoE: both prefills run again with every route call
    #    recorded; a batch row that a differing pick reaches is reported and
    #    left out, the other rows are held.
    plain_cfg = cfg.with_(use_pallas=False)
    flips, rows = [], set()
    if cfg.num_experts:
        with RouteRecorder() as kernel_routes:
            again = prefill_forward(cfg, params, prompts, **enc)[0]
        if not torch.equal(again, logits):
            raise AssertionError(f"{arch}: a second kernel prefill gave other logits")
        with RouteRecorder() as plain_routes:
            (plain_logits, plain_kv), plain_ms = wall_ms(
                lambda: prefill_forward(plain_cfg, params, prompts, **enc))
        flips, rows = route_flips(cfg, kernel_routes.calls, plain_routes.calls, prompt_len)
        del kernel_routes, plain_routes, again
        unexplained = [f for f in flips if f["first"] and not f["router_input_within_2e-3"]]
        if unexplained:
            raise AssertionError(f"{arch}: route picks differ where the router's input "
                                 f"disagrees beyond 2e-3: {unexplained[:4]}")
        if len(rows) == batch:
            raise AssertionError(f"{arch}: route differences reach every batch row: "
                                 f"{flips[:8]}")
    else:
        (plain_logits, plain_kv), plain_ms = wall_ms(
            lambda: prefill_forward(plain_cfg, params, prompts, **enc))
    held = torch.tensor([b for b in range(batch) if b not in rows], device="cuda")
    steps["plain_prefill"] = {
        "wall_ms": plain_ms,
        "rows_held": held.tolist(),
        "logits_max_abs_err": _close("logits", logits[held], plain_logits[held]),
        **{f"{n}_max_abs_err": _close(n, kv[n][:, held], plain_kv[n][:, held])
           for n in sorted(kv)},
    }
    if cfg.num_experts:
        steps["plain_prefill"]["route_differences"] = flips
        steps["plain_prefill"]["flipped_picks"] = sum(f["picks_differ"] for f in flips)
        # not gated: the rows left out, as far apart as they are
        out_rows = torch.tensor(sorted(rows), dtype=torch.long, device="cuda")
        steps["plain_prefill"]["rows_left_out_logits_max_abs_err"] = (
            (logits[out_rows] - plain_logits[out_rows]).abs().max().item() if rows else None)
    del plain_kv, kv

    # 7. the reference's own entry point: replay prefill, disaggregated,
    #    against monolithic generation
    short = prompts[:, :REPLAY_PROMPT].contiguous()
    replay_len = REPLAY_PROMPT + REPLAY_NEW
    retried_before = engine.slices_retried
    result, gen_ms = wall_ms(lambda: server.generate(short, REPLAY_NEW, replay_len, **enc))
    mono = monolithic_generate(cfg, params, short, REPLAY_NEW, replay_len, **enc)
    if not np.array_equal(result.tokens, mono):
        raise AssertionError("server.generate tokens differ from monolithic_generate")
    # not gated: kernel prefill vs replay prefill on the same short prompts
    k_logits, k_cache = prefill_forward(cfg, params, short, **enc)
    k_tokens = greedy_decode(cfg, params, decode_cache(cfg, k_cache, replay_len), k_logits,
                             REPLAY_PROMPT, REPLAY_NEW)
    steps["replay_generate"] = {
        "wall_ms": gen_ms, "kv_bytes": result.kv_bytes,
        "kv_transfer_seconds": result.kv_transfer_seconds,
        "equals_monolithic": True, "slices_retried": engine.slices_retried - retried_before,
        "tokens_agree_kernel_vs_replay_prefill": int((k_tokens == result.tokens).sum()),
        "tokens_compared": int(result.tokens.size),
    }
    out = {"phase": "serve", "arch": arch, "batch": batch, "prompt": prompt_len,
           "max_len": max_len, "new_tokens": n_new, "dtype": dt, "reduced": reduced,
           "main_path_launches": main_launches, "steps": steps}
    if enc:
        out["enc_frames"] = enc["enc_frames"].shape[1]
    emit(out)
    return out, (cfg, params, prompts, enc)


# ----------------------------------------------------------------------- profile
def _profiled(fn, top: int = 8) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler, CUPTI).
    Only device-side events are summed: an aten op's device time is its
    kernels', which are listed on their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    flash = sum(e.self_device_time_total for e in rows if FLASH_NAME in e.key) / 1e3
    ssd = sum(e.self_device_time_total for e in rows if SSD_PREFIX in e.key) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "device_busy_share": busy / wall,
            "flash_attention_ms": flash, "flash_attention_share": flash / busy if busy else 0.0,
            "ssd_scan_ms": ssd, "ssd_scan_share": ssd / busy if busy else 0.0,
            "top": [{"kernel": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in rows[:top]]}


def phase_profile(cfg, params, prompts, enc) -> dict:
    """Where a serve phase's time goes: one kernel prefill and eight greedy
    decode steps, each profiled once after a warm call."""
    prompt_len = prompts.shape[1]
    prefill = lambda: prefill_forward(cfg, params, prompts, **enc)  # noqa: E731
    logits, kv = prefill()
    cache = decode_cache(cfg, kv, prompt_len + 9)
    decode = lambda: greedy_decode(cfg, params, cache, logits, prompt_len, 9)  # noqa: E731
    decode()
    res = {"phase": "profile", "arch": cfg.name, "num_layers": cfg.num_layers,
           "dtype": str(params["embed"].dtype).removeprefix("torch."), "prefill": _profiled(prefill),
           "decode_8_steps": _profiled(decode)}
    emit(res)
    return res


# ----------------------------------------------------------------------- sharded
def _distributed(tree, tree_placements, mesh):
    """Each tensor of `tree` wrapped as a DTensor of its placements, its
    storage shared: on the one-card (1, 1) mesh the local shard is all of it."""
    if isinstance(tree, dict):
        return {k: _distributed(v, tree_placements[k], mesh) for k, v in tree.items()}
    return DTensor.from_local(tree, mesh, tree_placements, run_check=False)


def phase_sharded(cfg, params, prompts) -> dict:
    """The qwen3-moe f32 serve phase's model (full width, depth 2, its own
    parameters wrapped as DTensors of `param_shardings`' placements, not
    copied) under `activation_sharding` on the host mesh, over an NCCL group
    of this one card: the sharded prefill (flash on local shards under
    `local_map`, `moe_ffn_ep` in both layers) and 4 decode steps from a copy
    of its cache against the unsharded ones within 2e-3; `moe_ffn_ep` alone
    at T = 4096 and 4 against `moe_ffn_sorted` within 1e-4 (the reference's
    pin, tests/test_models.py:230-233); the NCCL collectives by kind
    (CommDebugMode); prefill, decode-step and MoE-FFN ms (CUDA events) with
    and without the mesh. Returns the main path's launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    B, S = prompts.shape
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dparams = _distributed(params, param_shardings(cfg, mesh, params), mesh)
        tok_pl = placements(batch_spec(mesh) + (None,), mesh)
        dprompts = DTensor.from_local(prompts, mesh, tok_pl, run_check=False)
        with torch.no_grad():
            want_logits, want_cache = prefill_forward(cfg, params, prompts)
            torch.cuda.synchronize()
            # the main path: the sharded prefill and its decode steps
            reset_launches()
            moe_mod.ep_calls = 0
            with CommDebugMode() as comm, activation_sharding(mesh):
                logits, cache = prefill_forward(cfg, dparams, dprompts)
                prefill_launches, ep_calls = read_launches(), moe_mod.ep_calls
                prefill_comm = {str(k): v for k, v in comm.get_comm_counts().items()}
                dcache = {n: DTensor.from_local(t, mesh, cache[n].placements, run_check=False)
                          for n, t in decode_cache(cfg, {n: c.to_local() for n, c in cache.items()},
                                                   S + SHARDED_DECODE).items()}
                tok = torch.argmax(want_logits, -1)[:, None].to(torch.int32)
                dtok = DTensor.from_local(tok, mesh, tok_pl, run_check=False)
                steps = []
                for i in range(SHARDED_DECODE):
                    out, dcache = decode_step(cfg, dparams, dcache, dtok, S + i)
                    steps.append(out)
                    dtok = torch.argmax(out, -1)[:, None].to(torch.int32)
            main_launches = read_launches()
            all_comm = {str(k): v for k, v in comm.get_comm_counts().items()}
            cache_plain = decode_cache(cfg, want_cache, S + SHARDED_DECODE)
            tok_plain, decode_errs = tok, []
            for i, out in enumerate(steps):
                want, cache_plain = decode_step(cfg, params, cache_plain, tok_plain, S + i)
                decode_errs.append(_close(f"sharded decode step {i}", out.full_tensor(), want))
                tok_plain = torch.argmax(want, -1)[:, None].to(torch.int32)
            decode_cache_errs = {n: _close(f"sharded decode cache[{n}]", dcache[n].full_tensor(),
                                           cache_plain[n]) for n in cache_plain}
        if ep_calls != cfg.num_layers:
            raise AssertionError(f"moe_ffn_ep ran expert-parallel {ep_calls} times in a "
                                 f"{cfg.num_layers}-layer sharded prefill")
        want_launches = expected_launches(cfg)
        if prefill_launches != want_launches or main_launches != want_launches:
            raise AssertionError(f"the sharded prefill launched {prefill_launches} (with decode "
                                 f"{main_launches}), expected {want_launches}")
        prefill_errs = {"logits": _close("sharded logits", logits.full_tensor(), want_logits),
                        **{n: _close(f"sharded cache[{n}]", cache[n].full_tensor(), want_cache[n])
                           for n in want_cache}}
        bit_equal = {"logits": torch.equal(logits.full_tensor(), want_logits),
                     **{n: torch.equal(cache[n].full_tensor(), want_cache[n]) for n in want_cache}}

        # moe_ffn_ep alone on layer 0's weights against moe_ffn_sorted
        lp0 = {k: dparams["layers"][k][0] for k in ("router", "w_gate", "w_up", "w_down")}
        lp0_plain = {k: params["layers"][k][0] for k in lp0}
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        moe = {}
        for T in MOE_TOKENS:
            x = torch.randn((T, cfg.d_model), generator=gen, device="cuda")
            dx = DTensor.from_local(x, mesh, placements(batch_spec(mesh) + (None,), mesh),
                                    run_check=False)
            with torch.no_grad():
                moe_mod.ep_calls = 0
                with activation_sharding(mesh):
                    got, got_aux = moe_mod.moe_ffn_ep(cfg, lp0, dx)
                want, want_aux = moe_mod.moe_ffn_sorted(cfg, lp0_plain, x)
            err = _close(f"moe_ffn_ep T={T}", got.full_tensor(), want, SHARDED_MOE_TOL)
            lb_err = abs(got_aux["lb_loss"].full_tensor().item() - want_aux["lb_loss"].item())
            if moe_mod.ep_calls != 1 or lb_err > SHARDED_MOE_TOL:
                raise AssertionError(f"moe_ffn_ep T={T}: ep calls {moe_mod.ep_calls}, "
                                     f"lb_loss off by {lb_err}")

            def sharded_ffn():
                with activation_sharding(mesh):
                    return moe_mod.moe_ffn_ep(cfg, lp0, dx)

            iters = 5 if T > 64 else 20
            with torch.no_grad():
                moe[f"T{T}"] = {"capacity": moe_mod.capacity(cfg, T), "max_abs_err": err,
                                "bit_equal": torch.equal(got.full_tensor(), want),
                                "lb_loss_abs_err": lb_err,
                                "dropped_sorted": int(want_aux["dropped"]),
                                "sharded_ms": cuda_ms(sharded_ffn, iters),
                                "plain_ms": cuda_ms(lambda: moe_mod.moe_ffn_sorted(
                                    cfg, lp0_plain, x), iters)}
            del x, dx, got, want

        def sharded_prefill():
            with activation_sharding(mesh):
                return prefill_forward(cfg, dparams, dprompts)

        def sharded_decode():
            with activation_sharding(mesh):
                return decode_step(cfg, dparams, dcache, dtok, S)

        with torch.no_grad():
            timing = {"prefill_sharded_ms": cuda_ms(sharded_prefill, 5),
                      "prefill_plain_ms": cuda_ms(lambda: prefill_forward(cfg, params, prompts), 5),
                      "decode_step_sharded_ms": cuda_ms(sharded_decode, 10),
                      "decode_step_plain_ms": cuda_ms(lambda: decode_step(
                          cfg, params, cache_plain, tok_plain, S), 10)}
        res = {"phase": "sharded", "arch": cfg.name, "mesh": sizes, "batch": B, "prompt": S,
               "reduced": {"num_layers": [get_config(SHARDED_ARCH).num_layers, cfg.num_layers]},
               "main_path_launches": main_launches, "moe_ffn_ep_engaged": ep_calls,
               "collectives_prefill": prefill_comm, "collectives_prefill_and_decode": all_comm,
               "prefill_max_abs_err": prefill_errs, "prefill_bit_equal": bit_equal,
               "decode_steps": SHARDED_DECODE, "decode_logits_max_abs_err": decode_errs,
               "decode_cache_max_abs_err": decode_cache_errs, "moe_ffn_ep": moe,
               "timing": timing}
        emit(res)
        return res
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------------ dryrun
def phase_dryrun() -> dict:
    """The port's multi-pod dry run for qwen3-moe-235b-a22b on both
    production meshes (4 shapes x 2 meshes, meta tensors under fake groups
    of 256 and 512 ranks): one subprocess a case (a process holds one
    default group), all started together, after the card's phases. Each
    must exit 0, and each case's analytic bytes a device must equal the
    reference's."""
    cases = [(shape, mp) for shape in dict.fromkeys(k[0] for k in DRYRUN_BYTES)
             for mp in (False, True)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        try:
            for n, (shape, mp) in enumerate(cases):
                log = open(Path(tmp) / f"{n}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
                     "--shape", shape, *(["--multi-pod"] if mp else []),
                     "--out", str(Path(tmp) / f"{n}.jsonl")],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
            for proc, _ in procs:
                proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        wall = time.perf_counter() - t0
        failed = [(cases[n], Path(log.name).read_text()[-3000:])
                  for n, (proc, log) in enumerate(procs) if proc.returncode != 0]
        if failed:
            raise AssertionError(f"the dry run failed in {[c for c, _ in failed]}:\n{failed[0][1]}")
        records = [json.loads(line) for n in range(len(cases))
                   for line in (Path(tmp) / f"{n}.jsonl").read_text().splitlines()]
        text = "".join(Path(log.name).read_text() for _, log in procs)
    rows = []
    for rec in records:
        want = DRYRUN_BYTES[(rec["shape"], rec["mesh"])]
        if rec["analytic_bytes_per_device"] != want:
            raise AssertionError(f"dry run {rec['shape']} {rec['mesh']}: "
                                 f"{rec['analytic_bytes_per_device']} bytes a device, "
                                 f"the reference's {want}")
        r = rec["roofline"]
        rows.append({"shape": rec["shape"], "mesh": rec["mesh"],
                     "analytic_bytes_per_device": rec["analytic_bytes_per_device"],
                     "reference_bytes_per_device": want, "fits_80GB": rec["fits_80GB"],
                     "flops": rec["flops"], "bytes": rec["bytes"],
                     "collective_bytes": rec["collective_bytes"],
                     "collectives": rec["collectives"], "loops": rec["loops"],
                     "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                     "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
                     "useful_ratio": rec["useful_ratio"], "seconds": rec["seconds"]})
    if len(rows) != len(DRYRUN_BYTES):
        raise AssertionError(f"the dry run wrote {len(rows)} records, expected "
                             f"{len(DRYRUN_BYTES)}:\n{text[-3000:]}")
    res = {"phase": "dryrun", "arch": DRYRUN_ARCH, "wall_s": wall,
           "cases_s": sum(r["seconds"] for r in rows), "cases": rows}
    emit(res)
    return res


# -------------------------------------------------------------------------- lint
def phase_lint() -> dict:
    """tentlint's strict run over its default paths, its reading of the
    CUDA builds against the libraries this run loaded, and one scenario
    under the runtime sanitizer. Any active finding, stale baseline entry,
    parse error, flag difference or sanitizer violation raises."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "tentlint.json"
        rc = tentlint.main(["--root", str(ROOT), "--strict", "--json", str(out)])
        report = json.loads(out.read_text())
    if rc != 0:
        active = [f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
                  for f in report["findings"] if not (f["suppressed"] or f["baselined"])]
        raise AssertionError(f"tentlint --strict exited {rc}: {active}, stale baseline "
                             f"{report['stale_baseline']}, parse errors {report['parse_errors']}")
    static = cuda_builds(Project(ROOT, iter_source_files([ROOT / "src" / "repro_torch"], ROOT)))
    loaded = loaded_builds()
    if sorted(loaded) != sorted(LINT_LIBRARIES):
        raise AssertionError(f"this run loaded {sorted(loaded)}, expected {sorted(LINT_LIBRARIES)}")
    if static != loaded:
        raise AssertionError(f"tentlint reads the CUDA builds as {static}; this run loaded {loaded}")
    with sanitized():
        flap = ScenarioRunner(get(SANITIZED_SCENARIO)).run()
    if flap.violations:
        raise AssertionError(f"{SANITIZED_SCENARIO} under the sanitizer: {flap.violations}")
    res = {"phase": "lint", "files": report["counts"]["files_scanned"],
           "counts": {k: report["counts"][k] for k in ("active", "suppressed", "baselined")},
           "stale_baseline": len(report["stale_baseline"]),
           "parse_errors": len(report["parse_errors"]),
           "libraries_compared": {name: {"sources": list(src), "flags": list(flags)}
                                  for name, (src, flags) in sorted(loaded.items())},
           "sanitized": {"scenario": SANITIZED_SCENARIO, "violations": flap.violations},
           "wall_s": time.perf_counter() - t0}
    emit(res)
    return res


# ------------------------------------------------------------------------- train
def train_batches(cfg, n, device=None):
    """The first `n` batches of SyntheticTokens(seed=SEED), TRAIN_BATCH x
    TRAIN_SEQ tokens each, on `device` (None: the card)."""
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    return [{k: torch.from_numpy(v).to(device or DEV) for k, v in data.example(i).items()}
            for i in range(n)]


def loss_and_grads(cfg, params, batch, remat):
    """The loss and every leaf's gradient, in the reference's leaf order."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_fn(cfg.with_(remat="full" if remat else "none"), params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


def remat_check(cfg) -> dict:
    """Full width, depth cut to REMAT_DEPTH, f32: the loss and every leaf's
    gradient with each layer checkpointed against without, within 1e-5
    (each leaf relative to its largest |g| without remat)."""
    cfg = cfg.with_(num_layers=REMAT_DEPTH)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, dtype=torch.float32, device=DEV)
    batch = train_batches(cfg, 1)[0]
    out = {}
    for remat in (True, False):
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), ms = wall_ms(lambda: loss_and_grads(cfg, params, batch, remat))
        out[remat] = (loss, grads, ms, torch.cuda.max_memory_allocated())
    names = [n for n, _ in named_leaves(params)]
    worst = {n: ((a - b).abs().max() / b.abs().max()).item()
             for n, a, b in zip(names, out[True][1], out[False][1])}
    loss_rel = abs(out[True][0].item() - out[False][0].item()) / abs(out[False][0].item())
    res = {"num_layers": REMAT_DEPTH, "dtype": "float32", "loss": out[False][0].item(),
           "loss_rel_diff": loss_rel, "worst_grad_rel_diff": max(worst.values()),
           "worst_leaf": max(worst, key=worst.get),
           "wall_ms": {"remat": out[True][2], "no_remat": out[False][2]},
           "max_memory_allocated": {"remat": out[True][3], "no_remat": out[False][3]}}
    if not (loss_rel <= 1e-5 and max(worst.values()) <= 1e-5):
        raise AssertionError(f"remat on and off disagree: {res}")
    return res


def card_vs_cpu_step(arch) -> dict:
    """One f32 train step of the smoke-size model on the card against the
    same step on the CPU: losses within 1e-5 relative, params within 2 lr
    everywhere (an Adam step moves a weight by about lr at most, so a tiny
    gradient whose sign differs moves it the other way)."""
    cfg = get_smoke_config(arch)
    step_fn = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS))
    init = init_params(cfg, torch.Generator().manual_seed(SEED), dtype=torch.float32,
                       device="cpu")
    params, metrics = {}, {}
    for dev in ("cpu", DEV):
        p = tree_map(lambda t, dev=dev: t.to(dev, copy=True), init)
        batch = train_batches(cfg, 1, device=dev)[0]
        params[dev], _, metrics[dev] = step_fn(p, init_opt_state(p), batch)
    lr = metrics["cpu"]["lr"].item()
    loss_rel = abs(metrics[DEV]["loss"].item() - metrics["cpu"]["loss"].item()) / abs(
        metrics["cpu"]["loss"].item())
    max_dp = max((a.cpu() - b).abs().max().item() for a, b in
                 zip(tree_leaves(params[DEV]), tree_leaves(params["cpu"])))
    res = {"arch": cfg.name, "loss_card": metrics[DEV]["loss"].item(),
           "loss_cpu": metrics["cpu"]["loss"].item(), "loss_rel_diff": loss_rel,
           "lr": lr, "params_max_abs_diff": max_dp, "params_bound": 2 * lr}
    if not (loss_rel <= 1e-5 and max_dp <= 2 * lr):
        raise AssertionError(f"the card's train step differs from the CPU's: {res}")
    return res


def phase_train():
    """The training path at full width and depth: qwen2-0.5b's 494M params
    in bf16 with fp32 moments and per-layer remat, as the reference's
    `train` runs it, over SyntheticTokens(seed=0). Plain attention (no
    kernel: training has no backward pass through one). Returns (the
    phase's line, cfg, the trained params)."""
    cfg = get_config(TRAIN_ARCH).with_(use_pallas=False, remat="full")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_params(cfg, gen, device=DEV)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name} has {n_params} params, expected {TRAIN_PARAMS}")
    opt_state = init_opt_state(params)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg)
    batches = train_batches(cfg, TRAIN_STEPS)
    with torch.no_grad():
        loss0 = loss_fn(cfg, params, batches[0])[0].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows, profile = [], None
    for i, batch in enumerate(batches):
        out = []
        step = lambda: out.append(step_fn(params, opt_state, batch))  # noqa: E731
        if i == TRAIN_PROFILED:
            profile = _profiled(step, top=12)
            ms = wall = None
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            step()
            end.record()
            end.synchronize()
            wall, ms = (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)
        params, opt_state, metrics = out[0]
        rows.append({"step": i, "loss": metrics["loss"].item(),
                     "grad_norm": metrics["grad_norm"].item(), "lr": metrics["lr"].item(),
                     "ms": ms, "wall_ms": wall})
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    losses = [r["loss"] for r in rows]
    timed = [r["ms"] for r in rows[1:] if r["ms"] is not None]
    step_ms = float(np.mean(timed))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"phase": "train", "arch": cfg.name, "params": n_params, "dtype": "bfloat16",
           "moments": "float32", "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": rows, "step_ms_mean": step_ms, "step_ms_steps": f"1-{TRAIN_STEPS - 1} "
           f"but {TRAIN_PROFILED} (profiled)", "tokens_per_s": tokens / (step_ms / 1e3),
           "wall_ms_mean": float(np.mean([r["wall_ms"] for r in rows[1:] if r["wall_ms"]])),
           "max_memory_allocated": peak, "launches": launches,
           "loss_no_grad_step0": loss0,
           "step0_rel_diff": abs(losses[0] - loss0) / abs(loss0),
           "profiled_step": {"step": TRAIN_PROFILED, **profile}}
    if launches != NO_LAUNCHES:
        raise AssertionError(f"training launched a hand-written kernel: {launches}")
    if not all(np.isfinite([r["loss"] for r in rows] + [r["grad_norm"] for r in rows])):
        raise AssertionError(f"non-finite loss or grad norm: {rows}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if not res["step0_rel_diff"] <= 1e-6:
        raise AssertionError(f"step 0's loss {losses[0]} != loss_fn under no_grad {loss0}")
    del opt_state
    torch.cuda.empty_cache()
    res["remat_check"] = remat_check(cfg)
    res["card_vs_cpu"] = card_vs_cpu_step(TRAIN_ARCH)
    emit(res)
    return res, cfg, params


# --------------------------------------------------------------------- rl_update
def rank_segments(engine, world):
    """The checkpoint engine's per-rank destination segments, found by their
    names ("ckpt-r<node>.<gpu>") among the engine's segments, in rank order."""
    by_name = {s.name: s for s in engine.segments.all_segments()}
    return [by_name[f"ckpt-r{r // RL_GPUS}.{r % RL_GPUS}"] for r in range(world)]


def rebuild_table(engine, table, world):
    """The weights as the ranks hold them: each rank's segment read whole,
    joined in rank order and cut at the tensors' offsets (sorted names, as
    `register_checkpoint` lays them out), each in its table entry's dtype
    and shape."""
    segs = rank_segments(engine, world)
    blob = np.concatenate([s.read(0, s.length) for s in segs])
    out, off = {}, 0
    for name in sorted(table):
        a = table[name]
        out[name] = np.frombuffer(blob, dtype=a.dtype, count=a.size, offset=off).reshape(a.shape)
        off += a.nbytes
    return out


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def phase_rl_update(cfg, params) -> dict:
    """The trained checkpoint through TENT to 16 ranks (the reference
    example's fabric: checkpoint_broadcast with rails (0, 1) and (0, 5)
    degraded to 25 % throughout), round_robin then tent, every rank checked
    byte for byte; the weights rebuilt from the ranks' segments equal the
    trainer's bit for bit, and a bf16 flash prefill on them equals the same
    prefill on the trainer's tensors. The main path (the refresh and the
    prefill on the refreshed weights) launches flash attention once a
    layer."""
    table = flatten_state(params)
    nbytes = sum(a.nbytes for a in table.values())
    world = RL_NODES * RL_GPUS
    spec = dataclasses.replace(
        get("checkpoint_broadcast"), name="rl_weight_update",
        faults=tuple(FaultEvent("degrade", node=node, nic=nic, at=0.0, until=1e9, factor=0.25)
                     for node, nic in RL_DEGRADED), seed=3)
    runner = ScenarioRunner(spec)
    reset_launches()  # the main path: the refresh, then a prefill on its weights
    policies = {}
    for policy in ("round_robin", "tent"):
        engine, _ = runner.build_engine(policy)
        ce = CheckpointEngine(engine, nodes=RL_NODES, gpus_per_node=RL_GPUS)
        _, register_ms = wall_ms(lambda: ce.register_checkpoint(table))
        res, update_ms = wall_ms(lambda: ce.update(verify=True))
        policies[policy] = {"virtual_s": res.seconds, "bytes": res.bytes, "ranks": res.ranks,
                            "gb_per_s": res.aggregate_bandwidth / 1e9,
                            "register_wall_ms": register_ms, "update_verify_wall_ms": update_ms,
                            "slices_issued": engine.slices_issued}
    ratio = policies["round_robin"]["virtual_s"] / policies["tent"]["virtual_s"]
    want_ratio = spec.expectations.tent_vs_baseline
    (refreshed, rebuild_ms) = wall_ms(
        lambda: unflatten_like(params, rebuild_table(engine, table, world)))
    differ = [n for (n, a), (_, b) in zip(named_leaves(refreshed), named_leaves(params))
              if not _bits_equal(a, b)]
    serve_cfg = cfg.with_(use_pallas=True)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (RL_PREFILL_BATCH, RL_PREFILL_LEN), generator=gen,
                            device=DEV)
    logits, prefill_ms = wall_ms(lambda: prefill_forward(serve_cfg, refreshed, prompts)[0])
    main_launches = read_launches()
    want = {**NO_LAUNCHES, "flash_attention": cfg.num_layers}
    trainer_logits = prefill_forward(serve_cfg, params, prompts)[0]
    del refreshed
    step0 = init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), device=DEV)
    step0_logits = prefill_forward(serve_cfg, step0, prompts)[0]
    del step0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trained.npz")
        _, save_ms = wall_ms(lambda: save_checkpoint(path, params))
        loaded, load_ms = wall_ms(lambda: load_checkpoint(path, params))
        npz_bytes = Path(path).stat().st_size
    npz_differ = [n for (n, a), (_, b) in zip(named_leaves(loaded), named_leaves(params))
                  if not _bits_equal(a, b)]
    del loaded
    res = {"phase": "rl_update", "arch": cfg.name, "checkpoint_bytes": nbytes,
           "bytes_per_rank": -(-nbytes // world), "ranks": world,
           "degraded_rails": [list(r) for r in RL_DEGRADED], "policies": policies,
           "round_robin_over_tent_s": ratio, "tent_vs_baseline": want_ratio,
           "rebuild_wall_ms": rebuild_ms, "leaves_differing": differ,
           "prefill": {"batch": RL_PREFILL_BATCH, "prompt": RL_PREFILL_LEN, "dtype": "bfloat16",
                       "wall_ms": prefill_ms, "equals_trainer_tensors": torch.equal(
                           logits, trainer_logits),
                       "differs_from_step0": not torch.equal(logits, step0_logits),
                       "max_abs_diff_vs_step0": (logits - step0_logits).abs().max().item()},
           "main_path_launches": main_launches,
           "npz": {"bytes": npz_bytes, "save_ms": save_ms, "load_ms": load_ms,
                   "leaves_differing": npz_differ}}
    emit(res)
    if nbytes != TRAIN_PARAMS * 2:
        raise AssertionError(f"the checkpoint holds {nbytes} bytes, expected {TRAIN_PARAMS * 2}")
    if ratio < want_ratio:
        raise AssertionError(f"tent is slower than round_robin: {policies}")
    if differ or npz_differ:
        raise AssertionError(f"refreshed weights differ from the trainer's: {differ} {npz_differ}")
    if not res["prefill"]["equals_trainer_tensors"] or not res["prefill"]["differs_from_step0"]:
        raise AssertionError(f"the refreshed prefill is wrong: {res['prefill']}")
    if not torch.isfinite(logits).all() or logits.shape != (RL_PREFILL_BATCH, cfg.vocab_size):
        raise AssertionError("the refreshed prefill's logits are not finite or misshapen")
    if main_launches != want:
        raise AssertionError(f"the rl_update main path launched {main_launches}, expected {want}")
    return res


# --------------------------------------------------------------------- moe_layer
def moe_bound(cfg, T, kept, experts_used, dtype) -> tuple:
    """Least time for the MoE FFN on this run's routing: the router's D x E
    product per token (float32, as `route` computes it) and the three
    expert products of each kept (token, expert) pair (6 D F flops), against
    the bytes of x and the output once, the router, and the weights of the
    experts the kept pairs use. Returns (ms, bound_by)."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    el = torch.finfo(dtype).bits // 8
    t_ops = 6.0 * D * F_ * kept / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32) + (
        2.0 * T * D * E / PEAK_F32)
    t_bytes = (el * (3 * D * F_ * experts_used + 2 * T * D + D * E)) / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def moe_bound_all_slots(cfg, T, dtype) -> tuple:
    """The same for what `moe_ffn_sorted` computes whatever the routing:
    every one of the E x C capacity slots and every expert's weights."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    slots = E * moe_mod.capacity(cfg, T)
    el = torch.finfo(dtype).bits // 8
    return _bound(6.0 * D * F_ * slots, el * 3 * D * F_ * E, dtype)


def phase_moe_layer() -> dict:
    """qwen3-moe-235b-a22b's MoE FFN alone at full width (128 experts of
    4096 x 1536, top 8), random weights from the seed as `init_params`
    draws them, at the prefill's T = 4096 (B = 4 x 1024) and decode's T = 4,
    f32 and bf16. Times by CUDA events and device times by the profiler:
    the layer, and three of its parts on inputs of their own shapes
    (routing; the expert products on (E, C, D) buckets; the combine of
    T x k rows); the dispatch (sort, bucket table, gathers) is the layer's
    device time less the parts'. Device ms by kernel from the profiler."""
    cfg = get_config(MOE_ARCH)
    D, F_, E, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p32 = {"router": dense_init(gen, D, (D, E), torch.float32)}
    for name, shape in (("w_down", (E, F_, D)), ("w_gate", (E, D, F_)), ("w_up", (E, D, F_))):
        p32[name] = dense_init(gen, shape[-2], shape, torch.float32)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        p = {n: t.to(dtype) for n, t in p32.items()}
        for T in MOE_TOKENS:
            C = moe_mod.capacity(cfg, T)
            x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
            out, aux = moe_mod.moe_ffn_sorted(cfg, p, x)
            if out.shape != (T, D) or out.dtype != dtype or not torch.isfinite(out).all():
                raise AssertionError(f"moe_ffn_sorted at T={T} {dt}: bad output")
            _, idx, _ = moe_mod.route(x, p["router"], k)
            keep = _kept(idx, C, E)
            kept = int(keep.sum())
            if kept != T * k - int(aux["dropped"]):
                raise AssertionError(f"moe_ffn_sorted at T={T} {dt}: dropped disagrees")
            experts_used = int(torch.unique(idx[keep]).numel())
            order = torch.argsort(idx.reshape(-1), stable=True)
            xe = torch.randn((E, C, D), generator=gen, device="cuda").to(dtype)
            contrib = torch.randn((T * k, D), generator=gen, device="cuda").to(dtype)
            iters = 5 if T > 64 else 20
            layer = lambda: moe_mod.moe_ffn_sorted(cfg, p, x)  # noqa: E731
            parts = {
                "route": lambda: moe_mod.route(x, p["router"], k),
                "experts": lambda: moe_mod._expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"]),
                "combine": lambda: moe_mod._combine(contrib, order, T, k, dtype),
            }
            times = {}
            for name, fn in parts.items():
                times[f"{name}_ms"] = cuda_ms(fn, iters)
                times[f"{name}_device_ms"] = device_ms(fn, "", iters)[0]
            ms, dev = cuda_ms(layer, iters), device_ms(layer, "", iters)[0]
            part_dev = [times[f"{name}_device_ms"] for name in parts]
            bound, bound_by = moe_bound(cfg, T, kept, experts_used, dtype)
            all_bound, all_by = moe_bound_all_slots(cfg, T, dtype)
            rows[f"{dt}_T{T}"] = {
                "T": T, "capacity": C, "slots": E * C, "dropped": int(aux["dropped"]),
                "kept_pairs": kept, "experts_used": experts_used, "ms": ms, "device_ms": dev,
                **times,
                "dispatch_device_ms": (dev - sum(part_dev)
                                       if dev is not None and None not in part_dev else None),
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_all_slots": all_bound, "bound_by_all_slots": all_by,
                "library_ms": None,  # no single PyTorch call computes a routed MoE FFN
                "profile": _profiled(layer, top=10),
            }
            del x, out, xe, contrib
        del p
    res = {"phase": "moe_layer", "arch": MOE_ARCH, "experts": E, "top_k": k,
           "d_model": D, "d_ff": F_, "rows": rows}
    emit(res)
    return res


# ----------------------------------------------------------------------- hicache
def phase_hicache() -> dict:
    """The reference example's HiCache section at full width: qwen2-0.5b
    pages of 64 tokens in GPU/CPU/disk pools of real bytes on the
    disagg_prefill_decode engine (its rail flap included). Two conversations
    of 4096 tokens with seeded payloads; the second demotes the first down a
    tier, which is then fetched back to the GPU tier. Every promoted page
    must hold the bytes that were inserted."""
    cfg = get_config("qwen2-0.5b")
    engine, _ = ScenarioRunner(get("disagg_prefill_decode")).build_engine("tent")
    page_bytes = kv_bytes_per_token(cfg) * HICACHE_PAGE_TOKENS
    gpu, cpu, disk = HICACHE_TIERS
    hc = HiCache(engine, cfg,
                 gpu_pool=make_gpu_pool(engine, 0, 0, page_bytes=page_bytes, num_pages=gpu),
                 cpu_pool=make_cpu_pool(engine, 1, page_bytes=page_bytes, num_pages=cpu),
                 disk_pool=make_disk_pool(engine, 1, page_bytes=page_bytes, num_pages=disk),
                 page_tokens=HICACHE_PAGE_TOKENS)
    rng = np.random.default_rng(SEED)
    convo_a = list(range(HICACHE_CONVO))
    convo_b = list(range(10**6, 10**6 + HICACHE_CONVO))
    n_bytes = HICACHE_CONVO // HICACHE_PAGE_TOKENS * page_bytes
    pay_a = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    pay_b = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    t0 = time.perf_counter()
    demote_a = hc.insert(convo_a, pay_a)
    demote_b = hc.insert(convo_b, pay_b)
    tiers_after_insert = hc.tier_counts()
    fetch = hc.fetch_prefix(convo_a)
    wall = (time.perf_counter() - t0) * 1e3
    got = np.concatenate([p.pool.read_page(p) for p in fetch.pages])
    if tiers_after_insert["gpu"] != gpu or sum(tiers_after_insert.values()) != 2 * gpu:
        raise AssertionError(f"the second conversation did not demote the first: "
                             f"{tiers_after_insert}")
    if fetch.prefix_tokens != HICACHE_CONVO or fetch.promoted_pages == 0:
        raise AssertionError(f"the first conversation was not fetched back: {fetch}")
    if not np.array_equal(got, pay_a):
        raise AssertionError("promoted pages do not hold the inserted bytes")
    res = {"phase": "hicache", "arch": cfg.name, "kv_bytes_per_token": kv_bytes_per_token(cfg),
           "page_tokens": HICACHE_PAGE_TOKENS, "page_bytes": page_bytes,
           "pools_pages": {"gpu": gpu, "cpu": cpu, "disk": disk},
           "host_bytes": page_bytes * (gpu + cpu + disk),
           "demote_seconds": [demote_a, demote_b], "tiers_after_insert": tiers_after_insert,
           "tiers_after_fetch": hc.tier_counts(), "promoted_pages": fetch.promoted_pages,
           "fetch_virtual_seconds": fetch.transfer_seconds, "bytes_moved": fetch.bytes_moved,
           "bytes_promoted": hc.bytes_promoted, "bytes_demoted": hc.bytes_demoted,
           "hits": hc.hits, "misses": hc.misses, "promoted_bytes_equal": True,
           "slices_retried": engine.slices_retried, "wall_ms": wall}
    emit(res)
    return res


# --------------------------------------------------------------------- scenarios
def phase_scenarios() -> dict:
    """Every library scenario through the port's scenario runner, with its
    declared expectations; one line each. Any violation fails the run."""
    t0 = time.perf_counter()
    failed, policies = {}, {}
    for name in names():
        s0 = time.perf_counter()
        report = ScenarioRunner(get(name)).run()
        policies[name] = report.to_dict()["policies"]
        emit({"phase": "scenario", "scenario": name, "ok": report.ok,
              "violations": report.violations, "wall_s": time.perf_counter() - s0,
              "policies": {p: {"throughput": r.throughput, "recovery_ms": r.recovery_ms,
                               "stall_ms": r.stall_ms, "retries": r.retries}
                           for p, r in report.policies.items()}})
        if report.violations:
            failed[name] = report.violations
    if failed:
        raise AssertionError(f"scenario expectations violated: {failed}")
    res = {"phase": "scenarios", "scenarios": len(names()), "violations": 0,
           "wall_s": time.perf_counter() - t0}
    emit(res)
    return res, policies


# ---------------------------------------------------------------------- jit_core
def _with_jit(spec, on=True):
    return dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, jit_core=on))


@contextlib.contextmanager
def forced_crossover():
    """Every wave and completion batch through the kernels: the adapter's
    crossover (JIT_MIN and its tuned bounds) pinned to 1."""
    saved = jit_core.JIT_MIN, jit_core.JIT_MIN_FLOOR, jit_core.JIT_MIN_CEIL
    jit_core.JIT_MIN = jit_core.JIT_MIN_FLOOR = jit_core.JIT_MIN_CEIL = 1
    try:
        yield
    finally:
        jit_core.JIT_MIN, jit_core.JIT_MIN_FLOOR, jit_core.JIT_MIN_CEIL = saved


@contextlib.contextmanager
def kernel_shapes():
    """Record the (candidates, slices) and (slots, completions) buckets the
    two engine kernels are launched at, through the chooser's binding and
    the drain's staged call."""
    seen = {"choose": {}, "drain": {}}
    choose, drain = tc_kernel.choose_wave_padded, tc_ops.card_drain

    def rec_choose(inp, out, pc, ps):
        seen["choose"][(pc, ps)] = seen["choose"].get((pc, ps), 0) + 1
        return choose(inp, out, pc, ps)

    def rec_drain(staging, ps, pm, m):
        seen["drain"][(ps, pm)] = seen["drain"].get((ps, pm), 0) + 1
        return drain(staging, ps, pm, m)

    tc_kernel.choose_wave_padded, tc_ops.card_drain = rec_choose, rec_drain
    try:
        yield seen
    finally:
        tc_kernel.choose_wave_padded, tc_ops.card_drain = choose, drain


def engage_transfer() -> dict:
    """The reference's engagement case (tests/test_jit_parity.py:69-118): on
    a zero-jitter fabric, 4 MiB in 64 slices over 8 identical rails, whose
    completions drain in same-timestamp groups of 8; the caller pins the
    crossover to 1. The bytes must arrive."""
    topo = Topology(FabricSpec())
    eng = TentEngine(topology=topo, fabric=Fabric(topo, seed=0, jitter=0.0),
                     config=EngineConfig(jit_core=True), device=DEV)
    n = 4 << 20
    src = eng.register_segment(Location(node=0, kind=MemoryKind.HOST_DRAM, numa=0), n)
    dst = eng.register_segment(Location(node=1, kind=MemoryKind.HOST_DRAM, numa=0), n)
    src.write(0, np.arange(n, dtype=np.uint8))
    res = eng.transfer_sync(src.segment_id, 0, dst.segment_id, 0, n)
    if not (res.ok and np.array_equal(dst.read(0, n), np.arange(n, dtype=np.uint8))):
        raise AssertionError("the jitted-core transfer did not deliver its bytes")
    return {"ok": True, "slices": eng.slices_issued, "kernel_waves": eng._jit.waves,
            "kernel_drains": eng._jit.drains, "virtual_s": res.completed_at - res.submitted_at}


def _pad_choose_args(rng, n_c, n_s, all_excluded=False):
    """The reference's randomized chooser inputs (tests/test_jit_parity.py:120)."""
    q = rng.integers(0, 1 << 28, size=n_c)
    gl = rng.uniform(0.0, 1e7, size=n_c)
    gr = rng.uniform(0.0, 1e7, size=n_c)
    bw = rng.choice([1e9, 25e9, 100e9], size=n_c)
    b0 = rng.uniform(0.0, 1e-3, size=n_c)
    b1 = rng.uniform(0.05, 10.0, size=n_c)
    pen = rng.choice([1.0, 1.0, 1.5, np.inf], size=n_c)
    ex = np.ones(n_c, dtype=bool) if all_excluded else rng.random(n_c) < 0.35
    lengths = rng.integers(1, 1 << 20, size=n_s)
    return q, gl, gr, bw, b0, b1, pen, ex, lengths


def _padded_choose(args):
    """The adapter's padding: candidates to a bucket with penalty inf and
    excluded, slices to a bucket marked invalid."""
    q, gl, gr, bw, b0, b1, pen, ex, lengths = args
    pc, ps = _bucket(len(q)), _bucket(len(lengths))

    def pad(a, n, fill):
        out = np.full(n, fill, dtype=np.float64)
        out[:len(a)] = a
        return out

    valid = pad(np.ones(len(lengths)), ps, 0.0)
    return (pad(q, pc, 0.0), pad(gl, pc, 0.0), pad(gr, pc, 0.0), pad(bw, pc, 1.0),
            pad(b0, pc, 0.0), pad(b1, pc, 1.0), pad(pen, pc, np.inf), pad(ex, pc, 1.0),
            pad(lengths, ps, 0.0), valid)


def max_abs_diff(pairs) -> float:
    """The largest |got - want| over (got, want) array pairs: 0.0 when every
    element is equal (inf against inf, nan against nan included), inf when
    one side is infinite and the other not."""
    err = 0.0
    for got, want in pairs:
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        if not same.all():
            diff = np.abs(got[~same] - want[~same])
            err = max(err, float(np.nan_to_num(diff, nan=np.inf).max()))
    return err


def check_choose(args, rr, gamma) -> tuple:
    """The chooser kernel (through the adapter's staged call) against the
    numpy `tent_choose_wave` on the valid prefix, and against its torch twin
    on the card on every padded output, bit for bit. Returns (bit-equal,
    the largest difference from either)."""
    n_c, n_s = len(args[0]), len(args[8])
    want = tent_choose_wave(*args, rr, gamma=gamma)
    padded = _padded_choose(args)
    c, qa, qo, rro = tc_ops.choose_wave_padded_np(padded, rr, gamma, tc_ops.Staging(DEV))
    tw = tent_choose_wave_padded_torch(*(torch.from_numpy(a).to(DEV) for a in padded), rr, gamma)
    twin = [t.cpu().numpy() for t in tw[:3]] + [int(tw[3])]
    got = (c[:n_s], qa[:n_s].astype(np.int64), qo[:n_c].astype(np.int64), rro)
    ok = (all(np.array_equal(np.asarray(w), np.asarray(g)) for w, g in zip(want, got))
          and np.array_equal(c, twin[0]) and np.array_equal(qa, twin[1])
          and np.array_equal(qo, twin[2]) and rro == twin[3])
    return ok, max_abs_diff(list(zip(got, want)) + list(zip((c, qa, qo, rro), twin)))


def _seeded_store(rng, n_links):
    """The reference's randomized telemetry store (tests/test_jit_parity.py)."""
    store = TelemetryStore()
    for i in range(n_links):
        desc = LinkDesc(link_id=i, node=0, link_class=LinkClass.RDMA, index=i, numa=0,
                        bandwidth=float(rng.choice([25e9, 1e9])), base_latency=5e-6)
        tl = store.ensure(desc)
        tl.queued_bytes = int(rng.integers(0, 1 << 30))
        tl.beta0 = float(rng.uniform(0.0, 1e-2))
        tl.beta1 = float(rng.uniform(0.05, 50.0))
        tl.ewma_service_time = float(rng.uniform(0.0, 1.0))
    return store


class _Policy:  # the drain only touches the store
    _rr = 0
    gamma = 0.05


_DRAIN_STATE = ("beta0_arr", "beta1_arr", "queued_arr", "ewma_service_arr", "completions_arr")


@functools.lru_cache(maxsize=None)
def drain_staging() -> tc_ops.Staging:
    return tc_ops.Staging(DEV)


def check_drain(seed, n_links, batch) -> tuple:
    """The drain kernel through the adapter (gather, the live entries
    staged, one launch, scatter) against the numpy store's drain, and on
    the padded batch, through the path's staged call and through the public
    `complete_many` on card buffers, against its torch twin on the card on
    the same m live entries, on every row, bit for bit; the scratch row and
    the inert rows past it must keep their gathered values. Returns
    (bit-equal, the largest difference from either, scratch rows kept)."""
    a, b, c = (_seeded_store(np.random.default_rng(seed), n_links) for _ in range(3))
    a.on_complete_many(*batch)
    EngineJitCore(_Policy(), b, device=DEV).on_complete_many(*batch)
    store_pairs = [(getattr(b, k)[:b.n], getattr(a, k)[:a.n]) for k in _DRAIN_STATE]
    same = all(np.array_equal(g, w) for g, w in store_pairs)
    ps, m = _bucket(n_links + 1), len(batch[0])
    pm = _bucket(m)
    state = c.gather_complete_state(ps)

    def pad(v):  # the tail past m is never read
        out = np.full(pm, np.nan)
        out[:m] = v
        return out

    tb = tuple(pad(v) for v in batch)
    want = [w.cpu().numpy() for w in tent_on_complete_many_torch(
        *(torch.from_numpy(a).to(DEV) for a in state), *(torch.from_numpy(v[:m]).to(DEV)
                                                         for v in tb))]
    staged = [g.copy() for g in tc_ops.complete_many_np(state, *tb, drain_staging(), m=m)]
    card = torch.from_numpy(np.concatenate(state + tb)).to(DEV)
    tc_kernel.complete_many(card[:8 * ps], card[8 * ps:], ps, pm, m)
    rows = card[:5 * ps].cpu().numpy()
    pairs, kept = list(store_pairs), True
    for got in (staged, [rows[i * ps:(i + 1) * ps] for i in range(5)]):
        pairs += list(zip(got, want))
        same = same and all(np.array_equal(g, w) for g, w in zip(got, want))
        kept = kept and all(np.array_equal(g[n_links:], s[n_links:]) for g, s in zip(got, state))
    return same and kept, max_abs_diff(pairs), kept


def _drain_batch(rng, n_links, m):
    return (rng.integers(0, n_links, size=m), rng.integers(0, 1 << 22, size=m),
            rng.integers(0, 1 << 24, size=m), rng.uniform(0.0, 5.0, size=m))


def jit_kernel_checks() -> dict:
    """Both engine kernels on randomized padded inputs at buckets 8-1024,
    the all-excluded wave, padding rows and the scratch row."""
    rng = np.random.default_rng(29)
    sizes = [(int(rng.integers(1, 11)), int(rng.integers(1, 50))) for _ in range(40)]
    sizes += [(30, 100), (8, 256), (100, 500), (500, 300), (1000, 1000), (12, 1024)]
    choose = [check_choose(_pad_choose_args(rng, n_c, n_s), int(rng.integers(0, 1000)),
                           float(rng.choice([0.0, 0.05, 0.2]))) for n_c, n_s in sizes]
    excluded = [check_choose(_pad_choose_args(rng, int(rng.integers(2, 9)), 8,
                                              all_excluded=True), 5, 0.05) for _ in range(20)]
    # a padded candidate (penalty inf, excluded) loses even to an excluded real rail
    one = tuple(np.asarray(v, dtype=float) for v in
                ([100], [0.0], [0.0], [1e9], [0.0], [1.0], [1.0], [True], [4096, 4096, 4096]))
    c, _, qo, rro = tc_ops.choose_wave_padded_np(_padded_choose(one), 0, 0.05,
                                                 tc_ops.Staging(DEV))
    padding = check_choose(one, 0, 0.05)
    padding_never = bool((c[:3] == 0).all() and rro == 3 and qo[0] == 100 + 3 * 4096
                         and padding[0])
    seam = {(n_c, n_s): check_choose(_pad_choose_args(rng, n_c, n_s), int(rng.integers(0, 1000)),
                                     float(rng.choice([0.0, 0.05, 0.2])))
            for n_c in CHOOSE_SEAM for n_s in CHOOSE_SEAM_SLICES}
    drains = [(int(rng.integers(1, 7)), int(rng.integers(1, 40))) for _ in range(30)]
    # the main path's 64 x 8; m = 1; ps = 2048 (eight blocks); pm = 8192
    # (five shared tiles)
    drains += [(63, 8), (16, 64), (100, 256), (1000, 1000), (6, 1024), (5, 1), (1500, 3000),
               (12, 5000)]
    drain = [check_drain(int(rng.integers(0, 1 << 30)), n_links, _drain_batch(rng, n_links, m))
             for n_links, m in drains]
    # every completion on one slot: one thread walks the whole batch
    for n_links, m in ((9, 300), (3, 1024)):
        slots, lengths, queued_at, t_obs = _drain_batch(rng, n_links, m)
        drains.append((n_links, m))
        drain.append(check_drain(int(rng.integers(0, 1 << 30)), n_links,
                                 (np.full(m, n_links - 1), lengths, queued_at, t_obs)))
    # the live count: rows 0..n-1 see only the real batch, the scratch row n
    # keeps its gathered value
    scratch = check_drain(9, 3, tuple(np.asarray(v) for v in (
        [0, 2, 2], [4096, 1 << 20, 0], [100, 5000, 0], [0.25, 0.5, 0.75])))
    bad = [i for i, (ok, _) in enumerate(choose) if not ok]
    bad_excluded = [i for i, (ok, _) in enumerate(excluded) if not ok]
    bad_drain = [i for i, (ok, _, _) in enumerate(drain) if not ok]
    bad_seam = [str(k) for k, (ok, _) in seam.items() if not ok]
    res = {"choose_cases": len(sizes), "choose_mismatches": bad,
           "seam_cases": len(seam), "seam_pc": sorted({_bucket(n_c) for n_c in CHOOSE_SEAM}),
           "seam_mismatches": bad_seam,
           "all_excluded_cases": len(excluded), "all_excluded_mismatches": bad_excluded,
           "padding_rows_never_selected": padding_never,
           "drain_cases": len(drains), "drain_mismatches": bad_drain,
           "drain_shapes": sorted({(_bucket(n + 1), _bucket(m)) for n, m in drains}),
           "scratch_row_survives": scratch[0] and all(kept for _, _, kept in drain),
           "choose_max_abs_err": max(err for _, err in choose + excluded + [padding]
                                     + list(seam.values())),
           "drain_max_abs_err": max(err for _, err, _ in drain + [scratch]),
           "buckets": sorted({_bucket(n) for pair in sizes + drains for n in pair})}
    if (bad or bad_excluded or bad_drain or bad_seam
            or not (padding_never and res["scratch_row_survives"])):
        raise AssertionError(f"the engine kernels disagree with their twins: {res}")
    return res


def _per_step(timing: dict, steps_key: str, ms_key: str = "kernel_ms") -> dict:
    """`timing` with `us_per_step`: the kernel's ms (`ms_key`) over its
    dependent serial steps, in microseconds (None where the ms is)."""
    ms = timing[ms_key]
    return {**timing, "us_per_step": None if ms is None else ms * 1e3 / max(timing[steps_key], 1)}


def _host_ms(fn, iters):
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def choose_timing(n_c, n_s) -> dict:
    """The chooser at one shape: the kernel entry on packed card buffers (CUDA
    events; profiler), its plain torch version on the card, the numpy
    twin on the host, the adapter's staged round trip (host clock, copies
    and the wait included). Bound: the packed buffers moved once, and per
    slice and candidate the score's 7 fp64 operations and the window test;
    the slices are dependent steps."""
    rng = np.random.default_rng(3)
    args = _pad_choose_args(rng, n_c, n_s)
    padded = _padded_choose(args)
    pc, ps = len(padded[0]), len(padded[8])
    inp = torch.from_numpy(np.concatenate(list(padded) + [np.array([7.0, 0.05])])).to(DEV)
    out = torch.empty(tc_kernel.choose_out_size(pc, ps), dtype=torch.float64, device=DEV)
    card = [torch.from_numpy(a).to(DEV) for a in padded]
    staging = tc_ops.Staging(DEV)
    kern = lambda: tc_kernel.choose_wave_padded(inp, out, pc, ps)  # noqa: E731
    nbytes = 8 * (tc_kernel.choose_in_size(pc, ps) + tc_kernel.choose_out_size(pc, ps))
    flops = 8.0 * pc * ps
    t_b, t_o = nbytes / HBM_BPS, flops / PEAK_F64
    return _per_step({
            "candidates": n_c, "slices": n_s, "pc": pc, "ps": ps, "serial_steps": ps,
            "kernel": "warp" if pc <= 32 else "block",
            "kernel_ms": cuda_ms(kern),
            **_device_fields(kern, CHOOSE_NAME),
            "plain_ms": cuda_ms(lambda: tent_choose_wave_padded_torch(*card, 7, 0.05),
                                iters=3, warmup=1),
            "numpy_ms": _host_ms(lambda: tent_choose_wave(*args, 7, gamma=0.05), 5),
            "adapter_ms": _host_ms(lambda: tc_ops.choose_wave_padded_np(
                padded, 7, 0.05, staging), 20),
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None}, "serial_steps")


def _drain_inputs(n_links, m, slots=None):
    """A seeded store's padded drain inputs for m completions (slots random,
    or `slots`), the tail past m NaN: (batch, ps, pm, state + batch as one
    float64 vector)."""
    batch = _drain_batch(np.random.default_rng(4), n_links, m)
    if slots is not None:
        batch = (np.asarray(slots),) + batch[1:]
    store = _seeded_store(np.random.default_rng(5), n_links)
    ps, pm = _bucket(n_links + 1), _bucket(m)
    cols = np.full((4, pm), np.nan)
    cols[:, :m] = batch
    return batch, ps, pm, np.concatenate(store.gather_complete_state(ps) + (cols.ravel(),))


def drain_timing(n_links, m, slots=None) -> dict:
    """The drain at one shape through the path's own call, one `StagedDrain`
    call, which launches the kernel in place on the mapped staging buffer
    and waits for it (`kernel_ms`: CUDA events over 20 calls;
    `kernel_device_ms`: the profiler's); as a variant the path does not
    take, the public `complete_many` on card buffers (`card_kernel_ms`: 20
    calls back to back; `card_kernel_device_ms`); the plain torch version
    on the card, the numpy twin on the host and the adapter's round trip.
    Bound: the state and the live batch moved once and ~16 fp64 operations
    per completion; the dependent steps are the most completions one slot
    takes, and `us_per_step` is the path's device time over them."""
    batch, ps, pm, inputs = _drain_inputs(n_links, m, slots)
    card = torch.tensor(inputs, device=DEV)
    state, card_batch = card[:8 * ps], card[8 * ps:]
    card_state = [state[i * ps:(i + 1) * ps].clone() for i in range(8)]
    card_cols = [card_batch[i * pm:i * pm + m].clone() for i in range(4)]
    kern = lambda: tc_kernel.complete_many(state, card_batch, ps, pm, m)  # noqa: E731
    staging = tc_ops.Staging(DEV)
    n = 8 * ps + 4 * pm
    staging.host(n)[1][:] = inputs
    staged = staging.drain(n)
    path = lambda: staged(ps, pm, m)  # noqa: E731
    card_device_ms, card_records = device_ms(kern, "tent_on_complete_many")
    numpy_store = _seeded_store(np.random.default_rng(5), n_links)
    adapter = EngineJitCore(_Policy(), _seeded_store(np.random.default_rng(5), n_links),
                            device=DEV)
    nbytes = 8 * (8 * ps + 4 * m + 5 * ps)
    t_b, t_o = nbytes / HBM_BPS, 16.0 * m / PEAK_F64
    return _per_step({
            "slots": n_links, "completions": m, "ps": ps, "pm": pm,
            "serial_steps": int(np.bincount(batch[0].astype(np.int64)).max()),
            "kernel_ms": cuda_ms(path),
            **_device_fields(path, "tent_on_complete_many"),
            "card_kernel_ms": cuda_ms(kern), "card_kernel_device_ms": card_device_ms,
            "card_kernel_device_records": card_records,
            "plain_ms": cuda_ms(lambda: tent_on_complete_many_torch(*card_state, *card_cols),
                                iters=3, warmup=1),
            "numpy_ms": _host_ms(lambda: numpy_store.on_complete_many(*batch), 5),
            "adapter_ms": _host_ms(lambda: adapter.on_complete_many(*batch), 20),
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None}, "serial_steps", "kernel_device_ms")


def drain_fixed_depth(depth=8, sizes=JIT_BUCKETS) -> dict:
    """The drain's kernel at one depth (every slot takes `depth`
    completions, in a seeded order) over batches of `sizes`: its time should
    not grow with the batch."""
    out = {}
    for m in sizes:
        slots = np.random.default_rng(m).permutation(np.repeat(np.arange(m // depth), depth))
        t = drain_timing(m // depth, m, slots)
        out[str(m)] = {k: t[k] for k in ("slots", "serial_steps", "kernel_ms",
                                         "kernel_device_ms", "kernel_device_records",
                                         "us_per_step")}
    return out


def drain_ab(n_links, m, rounds=200) -> dict:
    """The staging A/B at one shape, in turns (A B B A), host clock over
    `rounds` calls, each waited for: the path's call (`StagedDrain`: the
    kernel in place on the pinned buffer through its mapped pointer)
    against a round trip through a card copy built here from public calls
    (the buffer copied in, `complete_many` on the copy, the five updated
    vectors copied back), beside the path's call with no live entry (m =
    0). Both give the same rows. Emits its line."""
    _, ps, pm, inputs = _drain_inputs(n_links, m)
    n = 8 * ps + 4 * pm
    staging = tc_ops.Staging(DEV)
    call = staging.drain(n)
    pinned = torch.empty(n, dtype=torch.float64, pin_memory=True)
    card = torch.empty(n, dtype=torch.float64, device=DEV)

    def copied():
        card.copy_(pinned, non_blocking=True)
        tc_kernel.complete_many(card[:8 * ps], card[8 * ps:], ps, pm, m)
        pinned[:5 * ps].copy_(card[:5 * ps], non_blocking=True)
        torch.cuda.current_stream().synchronize()

    calls = {"mapped": (lambda: call(ps, pm, m), staging.host(n)[1]),
             "copied": (copied, pinned.numpy())}
    rows, staged = {}, {}
    for name in ("mapped", "copied", "copied", "mapped"):
        fn, buf = calls[name]
        buf[:] = inputs
        fn()
        rows.setdefault(name, buf[:5 * ps].copy())
        staged.setdefault(name, []).append(_host_ms(fn, rounds))
    empty = lambda: call(ps, pm, 0)  # noqa: E731
    res = {"phase": "drain_ab", "slots": n_links, "completions": m, "ps": ps, "pm": pm,
           "staged_ms": staged, "empty_ms": _host_ms(empty, rounds),
           "empty_device_ms": device_ms(empty, "tent_on_complete_many")[0],
           "rows_equal": np.array_equal(rows["mapped"], rows["copied"])}
    emit(res)
    if not res["rows_equal"]:
        raise AssertionError(f"the drain's staging A/B gives two results: {res}")
    return res


def jit_core_main_path() -> dict:
    """The jitted core's main path, every count set to 0 just before it, and
    the timings of both kernels, while nothing else uses the card."""
    with forced_crossover(), kernel_shapes() as shapes:
        reset_launches()
        t0 = time.perf_counter()
        engage = engage_transfer()
        engage["wall_ms"] = (time.perf_counter() - t0) * 1e3
        main = read_launches()
    engage["shapes"] = {k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}
    # the reference's engagement case: one wave, 16 drains of 8
    if not (main["tent_choose_wave_padded"] == 1 and main["tent_on_complete_many"] == 16
            and all(main[k] == 0 for k in main if not k.startswith("tent_"))):
        raise AssertionError(f"the jitted core's transfer launched {main}")
    # the kernels timed at the buckets the main path launched them at
    choose = max(shapes["choose"].items(), key=lambda kv: kv[1])[0]
    drain = max(shapes["drain"].items(), key=lambda kv: kv[1])[0]
    timing = {
        "tent_choose_wave_padded": choose_timing(*choose),
        "tent_on_complete_many": drain_timing(drain[0] - 1, drain[1]),
        "adapter_crossover": {str(b): {"choose": choose_timing(8, b), "drain": drain_timing(16, b)}
                              for b in JIT_BUCKETS},
        "drain_fixed_depth": drain_fixed_depth(),
        "drain_ab": drain_ab(drain[0] - 1, drain[1]),
    }
    return {"main_path": engage, "main_path_launches": main, "timing": timing}


def phase_jit_core(jit_off: dict, main_path: dict) -> dict:
    """The jitted core's checks. `jit_off` holds each library scenario's
    jit-off `policies` from the scenarios phase; `main_path` is
    `jit_core_main_path()`'s result. Times nothing, since it runs beside
    the sweep's worker processes: `finish_jit_core` times the library pass
    and emits the line once they have ended."""
    checks = jit_kernel_checks()
    # the engaging scenarios with jit_core on, against the jit-off reports;
    # each must still launch a kernel, or the list has gone stale
    differ, per_scenario = [], {}
    with kernel_shapes() as lib_shapes:
        reset_launches()
        for name in JIT_ENGAGING:
            before = tc_kernel.choose_launches + tc_kernel.drain_launches
            got = ScenarioRunner(_with_jit(get(name)), device=DEV).run().to_dict()["policies"]
            per_scenario[name] = tc_kernel.choose_launches + tc_kernel.drain_launches - before
            if got != jit_off[name] or not per_scenario[name]:
                differ.append(name)
        library = read_launches()
    with forced_crossover():
        reset_launches()
        for name in FORCED_CROSSOVER:
            got = ScenarioRunner(_with_jit(get(name)), device=DEV).run().to_dict()["policies"]
            if got != jit_off[name]:
                differ.append(f"{name} (crossover 1)")
        forced = read_launches()
    if differ:
        raise AssertionError(f"jit_core on changed the reports of {differ}, or launched no "
                             f"kernel there: {per_scenario}")
    # a recorder turns the jitted core off, loudly, and changes nothing
    spec = _with_jit(get("uniform_spray"))
    runner = ScenarioRunner(spec, device=DEV)
    plain = runner.run_policy(spec.policies[0]).to_dict()
    rec = FlightRecorder(capacity=1 << 18)
    reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        recorded = runner.run_policy(spec.policies[0], recorder=rec).to_dict()
    rec_launches = read_launches()["tent_choose_wave_padded"]
    warned = any(issubclass(w.category, RuntimeWarning) and "jitted core" in str(w.message)
                 for w in caught)
    waves = [pl for _, kind, pl in rec.events() if kind == OBS.WAVE]
    for pl in waves:
        replay_wave(pl)  # raises ProvenanceError on any pick it cannot reproduce
    recorder = {"scenario": spec.name, "warned": warned, "report_equal": recorded == plain,
                "launches_while_recorded": rec_launches, "waves_replayed": len(waves)}
    if not (warned and recorded == plain and rec_launches == 0 and waves):
        raise AssertionError(f"the recorded jit run misbehaved: {recorder}")
    res = {"phase": "jit_core", **main_path, "kernel_checks": checks,
           "library_scenarios": list(JIT_ENGAGING), "library_equal_jit_off": True,
           "library_launches": library,
           "library_launches_by_scenario": per_scenario,
           "library_shapes": {k: {str(s): n for s, n in v.items()} for k, v in lib_shapes.items()},
           "forced_crossover": list(FORCED_CROSSOVER), "forced_launches": forced,
           "recorder": recorder}
    return res


def finish_jit_core(res: dict) -> dict:
    """With the worker processes ended, the host this process's alone: one
    pass over the engaging scenarios with jit_core off and one with it on,
    each timed. Emits the jit_core line."""
    walls = {}
    for on in (False, True):
        t0 = time.perf_counter()
        for name in JIT_ENGAGING:
            ScenarioRunner(_with_jit(get(name), on), device=DEV).run()
        walls[on] = time.perf_counter() - t0
    res = {**res, "library_jit_off_s": walls[False], "library_s": walls[True]}
    emit(res)
    return res


# ---------------------------------------------------------------------- mc_sweep
def _worker_init():
    torch.set_num_threads(1)


def _numpy_lane(name, policy, seed):
    """One lane of the numpy twin, in a worker process: its output and s."""
    spec = get(name)
    p = compile_spray_program(spec)
    draws = make_draws(p, base_seed=spec.seed, seed_index=seed)
    t0 = time.perf_counter()
    out = simulate_spray_ref(p, draws, policy=policy, fault_jitter=MC_JITTER)
    return out, time.perf_counter() - t0


def _cpu_sweep_json(name, n_seeds):
    """The sweep on the CPU (the plain torch sim), in a worker process."""
    sweep = MonteCarloSweep(get(name), n_seeds=n_seeds, fault_jitter=MC_JITTER, device="cpu")
    return sweep.run().to_json(sort_keys=True)


def _plain_lanes(name, policy, n_seeds, device):
    """Every lane of the plain torch sim of one sweep, in a worker process
    (the plain sim is bound by its host dispatch, so processes run several
    at once): the (n_seeds, 5) outputs as numpy and the wall s."""
    spec = get(name)
    p = compile_spray_program(spec)
    draws = stack_draws(p, n_seeds, base_seed=spec.seed)
    t0 = time.perf_counter()
    out = spray_sim_ref(p, draws, policy=policy, fault_jitter=MC_JITTER, device=device)
    out = out.cpu().numpy()
    return out, time.perf_counter() - t0


def sim_plan(p, n_lanes) -> dict:
    """The spray_sim kernel's launch for n_lanes lanes of p on this card:
    threads a lane (G), windows in registers or shared memory, lanes a
    block, blocks. The binding's shared-memory size of a lane must equal the
    built library's own (`spray_sim_group_bytes`)."""
    plan = sim_kernel.plan_for(p, n_lanes, sim_kernel._n_sms(torch.device(DEV)))
    lib_bytes = sim_kernel.load().spray_sim_group_bytes(
        p.n_rails, p.wave, p.fail_start.shape[1], p.degs_start.shape[1], p.degd_start.shape[1],
        int(plan.fault_cap == 0))
    if lib_bytes != plan.group_bytes:
        raise AssertionError(f"spray_sim's layout is {lib_bytes} bytes a lane in the library, "
                             f"{plan.group_bytes} in the binding")
    return {**dataclasses.asdict(plan), "threads_per_block": plan.threads_per_block}


def sim_bound(p, n_lanes) -> tuple:
    """Least time for a sweep: the draws read once and the outputs written
    once; per lane and slice the tent score over D + 1 rails (5 fp64
    operations each) and some 35 operations of posting and draining, first
    attempts only (this run's retries add well under 1 %). Each lane is
    rounds x wave dependent steps."""
    per_lane = (p.fail_start.size * 2 + p.degs_start.size * 3 + p.degd_start.size * 3
                + p.rounds * p.wave * 2 + 5)
    t_b = 8.0 * per_lane * n_lanes / HBM_BPS
    t_o = n_lanes * p.rounds * p.wave * (5.0 * (p.n_rails + 1) + 35) / PEAK_F64
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# the plain sims that are timed run in this process once the worker
# processes have ended, so that their walls share the host with nothing
TIMED_PLAIN = ("single_rail_flap", "tent")


def start_mc_jobs(pool) -> dict:
    """The sweep's host-heavy checks, started in worker processes: the plain
    sim on the card for each scenario and policy but TIMED_PLAIN (the
    longest first), the CPU sweep of the flap, and the numpy twin's lanes
    (also those of MC_OTHER).
    No time they take is reported as a time of the port: seven processes
    share the card and the host's cores."""
    order = sorted(((n, pol) for n in MC_SCENARIOS for pol in SWEEP_POLICIES
                    if (n, pol) != TIMED_PLAIN),
                   key=lambda k: -compile_spray_program(get(k[0])).rounds)
    return {"plain": {key: pool.submit(_plain_lanes, *key, MC_SEEDS, DEV) for key in order},
            "cpu_json": pool.submit(_cpu_sweep_json, "single_rail_flap", MC_SEEDS),
            "lanes": {(n, pol, s): pool.submit(_numpy_lane, n, pol, s)
                      for n in MC_SCENARIOS for pol in SWEEP_POLICIES for s in MC_NUMPY_SEEDS},
            "other": {(n, pol, s): pool.submit(_numpy_lane, n, pol, s)
                      for n in MC_OTHER for pol in SWEEP_POLICIES
                      for s in range(MC_OTHER_SEEDS)}}


def mc_workers():
    return ProcessPoolExecutor(MC_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_worker_init)


def other_programs(jobs: dict) -> dict:
    """spray_sim on the sweepable library programs outside BENCH_mc.json's
    five (one launch a program and policy, MC_OTHER_SEEDS lanes), every lane
    bit-equal to the numpy twin's (from the worker processes); with the
    launch plan each ran with. Times nothing."""
    rows, failed, errs = {}, [], []
    for name in MC_OTHER:
        spec = get(name)
        p = compile_spray_program(spec)
        draws = stack_draws(p, MC_OTHER_SEEDS, base_seed=spec.seed)
        row = {"rails": p.n_rails, "rounds": p.rounds, "wave": p.wave,
               "windows": [p.fail_start.shape[1], p.degs_start.shape[1], p.degd_start.shape[1]],
               "plan": sim_plan(p, MC_OTHER_SEEDS)}
        for pol in SWEEP_POLICIES:
            k = spray_sim(p, draws, policy=pol, fault_jitter=MC_JITTER, device=DEV).cpu().numpy()
            numpy = [jobs["other"][(name, pol, s)].result()[0] for s in range(MC_OTHER_SEEDS)]
            equal = all(tuple(k[s].tolist()) == lane for s, lane in enumerate(numpy))
            errs.append(max_abs_diff([(k[s], lane) for s, lane in enumerate(numpy)]))
            row[f"{pol}_lanes_equal_numpy_twin"] = equal
            if not equal:
                failed.append(f"{name}/{pol}")
        rows[name] = row
    if failed:
        raise AssertionError(f"spray_sim differs from the numpy twin on {failed}: {rows}")
    return {"programs": rows, "lanes_each": MC_OTHER_SEEDS, "max_abs_err": max(errs)}


def phase_mc_sweep(jobs: dict) -> dict:
    """The Monte Carlo sweep on the card, its lanes held against the jobs of
    `start_mc_jobs`. Times nothing, since the workers share the host; returns
    what `finish_mc_sweep` checks, times and reports once they have ended."""
    bench = {r["scenario"].removesuffix("::mc"): r
             for r in json.loads((ROOT / "BENCH_mc.json").read_text())["reports"]}
    sweeps = {n: MonteCarloSweep(get(n), n_seeds=MC_SEEDS, fault_jitter=MC_JITTER, device=DEV)
              for n in MC_SCENARIOS}
    plain, lanes = jobs["plain"], jobs["lanes"]
    # the main path: the five sweeps, every count set to 0 just before
    torch.cuda.synchronize()
    reset_launches()
    reports = {n: s.run() for n, s in sweeps.items()}
    torch.cuda.synchronize()
    main = read_launches()
    if main != {**NO_LAUNCHES, "spray_sim": len(MC_SCENARIOS) * len(SWEEP_POLICIES)}:
        raise AssertionError(f"the sweeps launched {main}")
    rows, failed, timed_lanes, errs = {}, [], None, []
    for name, sweep in sweeps.items():
        rep, p = reports[name], sweep.program
        draws = stack_draws(p, MC_SEEDS, base_seed=sweep.base_seed)
        row = {"rounds": p.rounds, "wave": p.wave, "rails": p.n_rails, "ok": rep.ok,
               "violations": list(rep.violations), "policies": {}}
        for pol in SWEEP_POLICIES:
            k = spray_sim(p, draws, policy=pol, fault_jitter=MC_JITTER,
                          device=DEV).cpu().numpy()
            numpy = [lanes[(name, pol, s)].result()[0] for s in MC_NUMPY_SEEDS]
            dist = rep.policies[pol]
            summary = dist.summary
            cell = row["policies"][pol] = {
                "lanes_equal_report": tuple(k[:, 0].tolist()) == dist.throughput,
                "seeds_equal_numpy_twin": all(tuple(k[s].tolist()) == lane
                                              for s, lane in zip(MC_NUMPY_SEEDS, numpy)),
                "throughput_p50": summary["throughput_p50"],
                "healing_p999_ms": summary["healing_p999_ms"],
                "lost_total": summary["lost_total"]}
            pairs = [(k[s], lane) for s, lane in zip(MC_NUMPY_SEEDS, numpy)]
            if (name, pol) == TIMED_PLAIN:
                timed_lanes = k  # held against the plain sim by finish_mc_sweep
            else:
                out, cell["plain_in_worker_s"] = plain[(name, pol)].result()
                cell["lanes_equal_plain_on_card"] = k.tobytes() == out.tobytes()
                pairs.append((k, out))
                if not cell["lanes_equal_plain_on_card"]:
                    failed.append(f"{name}/{pol} lanes against the plain sim")
            cell["max_abs_err"] = max_abs_diff(pairs)
            errs.append(cell["max_abs_err"])
            if not (cell["lanes_equal_report"] and cell["seeds_equal_numpy_twin"]):
                failed.append(f"{name}/{pol} lanes")
        want = bench[name]["policies"]["tent"]["extra"]["throughput_p50"]
        got = row["policies"]["tent"]["throughput_p50"]
        row["tent_throughput_p50_vs_bench"] = got / want
        bound = get(name).expectations.healing_p999_ms
        row["healing_p999_bound_ms"] = bound
        if not rep.ok:
            failed.append(f"{name} violations {list(rep.violations)}")
        if abs(got / want - 1.0) > MC_BAND:
            failed.append(f"{name} tent throughput P50 {got} vs BENCH_mc.json {want}")
        if bound > 0 and not 0 <= row["policies"]["tent"]["healing_p999_ms"] <= bound:
            failed.append(f"{name} healing P99.9 over {bound} ms")
        rows[name] = row
    flap_equal = (jobs["cpu_json"].result()
                  == reports["single_rail_flap"].to_json(sort_keys=True))
    if not flap_equal:
        failed.append("single_rail_flap report differs between the card and the CPU")
    numpy_s = [lanes[key].result()[1] for key in lanes]
    if failed:
        raise AssertionError(f"the Monte Carlo sweep failed: {failed}")
    other = other_programs(jobs)
    res = {"phase": "mc_sweep", "main_path_launches": main, "workers": MC_WORKERS,
           "plans": {n: sim_plan(s.program, MC_SEEDS) for n, s in sweeps.items()},
           "flap_report_equal_cpu": flap_equal, "numpy_lanes_checked": len(numpy_s),
           "numpy_in_worker_ms_per_lane": float(np.mean(numpy_s)) * 1e3,
           "other_programs": other}
    return {"res": res, "rows": rows, "sweeps": sweeps, "reports": reports,
            "timed_lanes": timed_lanes, "max_abs_err": max(errs + [other["max_abs_err"]])}


def _timed_plain(p, draws, policy, n_lanes) -> tuple:
    """The plain torch sim on the card over every lane, alone on the host:
    its (n_lanes, 5) outputs as numpy and its wall ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = spray_sim_ref(p, draws, policy=policy, fault_jitter=MC_JITTER, device=DEV)
    out = out.cpu().numpy()
    return out, (time.perf_counter() - t0) * 1e3


def finish_mc_sweep(state: dict) -> dict:
    """With the worker processes ended, the host and the card this
    process's alone: the flap's tent lanes against the plain sim (timed),
    one numpy lane (timed), a second, timed pass of the main path with the
    draws timed on their own (its reports byte-equal to the first's), one
    4096-seed flap_storm sweep against the plain sim's 4096 lanes (both
    timed), and the kernel timed at the flap's shape. Emits the
    mc_scenario lines and the mc_sweep line."""
    sweeps, rows, reports = state["sweeps"], state["rows"], state["reports"]
    name, pol = TIMED_PLAIN
    flap = sweeps[name]
    draws = stack_draws(flap.program, MC_SEEDS, base_seed=flap.base_seed)
    plain_out, plain_ms = _timed_plain(flap.program, draws, pol, MC_SEEDS)
    k = state["timed_lanes"]
    t0 = time.perf_counter()
    lane0 = simulate_spray_ref(flap.program, {key: v[0] for key, v in draws.items()},
                               policy=pol, fault_jitter=MC_JITTER)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    cell = rows[name]["policies"][pol]
    cell["lanes_equal_plain_on_card"] = k.tobytes() == plain_out.tobytes()
    cell["plain_on_card_ms"] = plain_ms
    cell["max_abs_err"] = max_abs_diff([(k, plain_out), (k[0], lane0)])
    if not (cell["lanes_equal_plain_on_card"] and tuple(k[0].tolist()) == lane0):
        raise AssertionError(f"{name}/{pol} lanes differ from the plain sim or the numpy twin")
    for n, row in rows.items():
        emit({"phase": "mc_scenario", "scenario": n, **row})
    # the main path again, timed: the draws alone first (a sweep draws once
    # for both its policies), then the five sweeps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in sweeps.values():
        stack_draws(s.program, MC_SEEDS, base_seed=s.base_seed)
    draws_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = {n: s.run() for n, s in sweeps.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    if any(again[n].to_json(sort_keys=True) != reports[n].to_json(sort_keys=True)
           for n in sweeps):
        raise AssertionError("a repeated sweep's report differs from the first")
    big = sweeps[MC_BIG_SCENARIO]
    t0 = time.perf_counter()
    big_draws = stack_draws(big.program, MC_BIG, base_seed=big.base_seed)
    big_draws_s = time.perf_counter() - t0
    big_kern, big_kern_ms = wall_ms(lambda: spray_sim(
        big.program, big_draws, policy="tent", fault_jitter=MC_JITTER, device=DEV))
    big_k = big_kern.cpu().numpy()
    del big_kern
    big_card = [torch.from_numpy(big_draws[key]).to(DEV) for key in ("uf", "us", "ud", "jm")]
    big_only_ms = cuda_ms(lambda: sim_kernel.spray_sim(
        big.program, *big_card, round_robin=False, fault_jitter=MC_JITTER), iters=2, warmup=1)
    del big_card
    big_out, big_plain_ms = _timed_plain(big.program, big_draws, "tent", MC_BIG)
    del big_draws
    heal = big_k[:, 1]
    heal_ms = np.where(heal < 0, -1.0, np.minimum(heal * 1e3, 1e9))
    healed = heal_ms[heal_ms >= 0]
    b_bound, b_by = sim_bound(big.program, MC_BIG)
    big_row = {"scenario": MC_BIG_SCENARIO, "lanes": MC_BIG,
               "serial_steps_per_lane": big.program.rounds * big.program.wave,
               "plan": sim_plan(big.program, MC_BIG),
               "draws_s": big_draws_s, "kernel_wall_ms": big_kern_ms,
               "kernel_ms": big_only_ms,
               "us_per_step": big_only_ms * 1e3 / (big.program.rounds * big.program.wave),
               "plain_on_card_wall_ms": big_plain_ms,
               "lanes_equal_plain_on_card": big_k.tobytes() == big_out.tobytes(),
               "max_abs_err": max_abs_diff([(big_k, big_out)]),
               "tent_healing_p999_ms": float(np.percentile(healed, 99.9)),
               "tent_healing_p50_ms": float(np.percentile(healed, 50)),
               "tent_throughput_p50": float(np.percentile(big_k[:, 0], 50)),
               "bound_ms": b_bound, "bound_by": b_by}
    if not big_row["lanes_equal_plain_on_card"]:
        raise AssertionError("the 4096-seed sweep's lanes differ from the plain sim")
    # the kernel alone at the flap's shape (64 lanes)
    p = flap.program
    card = [torch.from_numpy(draws[key]).to(DEV) for key in ("uf", "us", "ud", "jm")]
    kern = lambda: sim_kernel.spray_sim(p, *card, round_robin=False,  # noqa: E731
                                        fault_jitter=MC_JITTER)
    bound, bound_by = sim_bound(p, MC_SEEDS)
    timing = {"lanes": MC_SEEDS, "serial_steps_per_lane": p.rounds * p.wave,
              "plan": sim_plan(p, MC_SEEDS),
              "kernel_ms": cuda_ms(kern, iters=3, warmup=1),
              **_device_fields(kern, "spray_sim", iters=2),
              "plain_ms": plain_ms, "numpy_ms_per_lane": numpy_ms,
              "numpy_ms": numpy_ms * MC_SEEDS,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
              "max_abs_err": max([state["max_abs_err"], cell["max_abs_err"],
                                  big_row["max_abs_err"]]),
              "big": big_row}
    timing = _per_step(timing, "serial_steps_per_lane")
    res = {**state["res"], "main_path_s": main_s, "main_path_draws_s": draws_s,
           "repeat_reports_equal": True, "timing": timing}
    emit(res)
    return res


def _summary(name, source, replaces, launches, timing) -> dict:
    out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(launches.values()), "launches_by_path": launches,
           "max_abs_err": timing["max_abs_err"], "ms": timing["kernel_ms"],
           "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
           "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}
    for key in ("numpy_ms", "serial_steps", "serial_steps_per_lane", "us_per_step", "plan",
                "kernel_device_ms", "kernel_device_records", "card_kernel_ms",
                "card_kernel_device_ms", "adapter_ms"):
        if key in timing:
            out[key] = timing[key]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    phase_env()
    kern = phase_kernels()
    launches = {name: {} for name in COUNTERS}
    kv = phase_kv_path()  # counts its main path only
    for name in ("kv_pack", "kv_unpack"):
        launches[name]["kv_path"] = kv["launches"][name]
    for arch, batch, prompt_len, n_new, dtype, depth in SERVES:
        # counts its main path only
        serve, model = phase_serve(arch, batch, prompt_len, n_new, dtype, depth)
        path = arch if dtype == torch.float32 else f"{arch}/{serve['dtype']}"
        for name, n in serve["main_path_launches"].items():
            if n:
                launches[name][path] = n
        phase_profile(*model)
        if arch == SHARDED_ARCH and dtype == torch.float32:
            sharded = phase_sharded(*model[:3])  # counts its main path only
            launches["flash_attention"][f"{arch}/sharded"] = (
                sharded["main_path_launches"]["flash_attention"])
        del serve, model
        torch.cuda.empty_cache()
    _, train_cfg, trained = phase_train()
    torch.cuda.empty_cache()
    rl = phase_rl_update(train_cfg, trained)  # counts its main path only
    launches["flash_attention"]["rl_update"] = rl["main_path_launches"]["flash_attention"]
    del trained
    torch.cuda.empty_cache()
    phase_moe_layer()
    torch.cuda.empty_cache()
    phase_hicache()
    _, jit_off = phase_scenarios()
    jit_main = jit_core_main_path()
    with mc_workers() as pool:
        # the sweep's host-heavy checks run in worker processes beside the
        # checks of jit_core and mc_sweep, which time nothing
        jobs = start_mc_jobs(pool)
        jit_checks = phase_jit_core(jit_off, jit_main)
        mc_state = phase_mc_sweep(jobs)
    jit = finish_jit_core(jit_checks)
    mc = finish_mc_sweep(mc_state)
    phase_dryrun()
    phase_lint()
    for name in ("tent_choose_wave_padded", "tent_on_complete_many"):
        launches[name]["engage_transfer"] = jit["main_path_launches"][name]
    launches["spray_sim"]["mc_sweep"] = mc["main_path_launches"]["spray_sim"]
    jt = jit["timing"]
    t = kern["timing"]  # float32 rows; the kernels line above has every dtype and shape
    emit({"kernels": [
        _summary("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:89",
                 launches["flash_attention"], t["flash_attention"]["float32"]),
        _summary("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:71",
                 launches["ssd_scan"], t["ssd_scan"]["float32"]),
        _summary("kv_pack", "src/repro_torch/csrc/kv_pack.cu",
                 "src/repro/kernels/kv_pack/kernel.py:29",
                 launches["kv_pack"], t["kv_pack"]["float32"]),
        _summary("kv_unpack", "src/repro_torch/csrc/kv_pack.cu",
                 "src/repro/kernels/kv_pack/kernel.py:52",
                 launches["kv_unpack"], t["kv_unpack"]["float32"]),
        _summary("tent_choose_wave_padded", "src/repro_torch/csrc/tent_core.cu",
                 "src/repro/core/scheduler.py:552", launches["tent_choose_wave_padded"],
                 {**jt["tent_choose_wave_padded"],
                  "max_abs_err": jit["kernel_checks"]["choose_max_abs_err"]}),
        _summary("tent_on_complete_many", "src/repro_torch/csrc/tent_core.cu",
                 "src/repro/core/scheduler.py:489", launches["tent_on_complete_many"],
                 {**jt["tent_on_complete_many"],
                  "max_abs_err": jit["kernel_checks"]["drain_max_abs_err"]}),
        _summary("spray_sim", "src/repro_torch/csrc/spray_sim.cu",
                 "src/repro/core/jit_core.py:504", launches["spray_sim"], mc["timing"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
