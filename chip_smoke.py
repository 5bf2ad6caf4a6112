"""Chip smoke test of the PyTorch + CUDA port (fedmse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card. It
builds the CUDA kernels and the host CSV reader from fedmse_tpu_torch/csrc
(one nvcc or g++ per source, all started together, into
build/fedmse_tpu_torch/), then:

  1. device     prints the card (nvidia-smi name and power limit), torch and
                CUDA versions and the kernels' build time;
  2. kernels    holds each kernel (the fused forward, the fused train step
                and the kNN distance tiles) against its plain PyTorch
                version on the card, at every listed shape and dtype (the
                forward under client-major, routed and single-model
                layouts; the forward and the train step also against a
                second call, bit for bit, and as exactly one CUDA kernel
                per call, counted as the nodes of the call captured into a
                CUDA graph, their f32 cases on dyadic grids; the distance
                tiles' cases include the evaluation's shape, whose rows
                phase 3 then checks: each also bit-equal to a second
                call, one CUDA kernel per call in f32 and bf16, routed
                rows the client-major rows' bits);
  3. evaluate   per-client AUC of both model types in f32 and bf16 over a
                10-gateway synthetic federation at the paper's width
                (115 -> 27 -> 7), ~70k rows per evaluation, with the
                model's own score and with the kNN score (512-slot banks,
                k = 8, exact and approximate top-k);
  4. serve      ServingEngine.from_federation -> fit_calibration ->
                MicroBatcher over >= 8192 interleaved rows (scores held to
                the evaluator's oracle), then a 512-gateway engine with
                gather routing scoring 1024-row buckets; the same for the
                kNN score, plus a ContinuousBatcher stream with a
                build_banks(existing=...) bank swap in its middle;
  5. train      main.run_combination on the same federation with the
                quick-run schedule (3 rounds, 5 epochs, batch 12, 50%
                participation) on the driver's default path, the fused,
                pipelined schedule (each round's bodies CUDA graphs
                captured once per engine and replayed): all six
                combinations in f32 and hybrid / mse_avg in bf16; the
                trained hybrid checkpoint is then
                served by ServingEngine.from_checkpoint and held to the
                evaluator's oracle, and run through the CLI's --serve
                pass (serving.run_serve_smoke) with the kNN score and the
                continuous front, three times cold and once warm, after
                one forced full collection timed with and without the
                gc.freeze() the pass holds over its stream;
     orders     (after the main path) hybrid / mse_avg again in both
                dtypes at 4, 2 and 1 CTAs per client: bf16 is held to f32
                on the mean final AUC over the four summation orders;
     fused-hold the fused round held to the per-phase round from one
                init, cohort and data, tie-break off (hybrid / mse_avg
                and autoencoder / fedprox in f32, hybrid / mse_avg in
                bf16, one kNN-scored round): states and round results
                within 1e-6 scale-normalized, and a second fused round
                from the same state (a replay) the first's bits;
     robust     (after the main path) the fault path at 115/27/7 on the
                10 gateways, hybrid / mse_avg: (b) run_combination on the
                driver's default schedule, one round a chunk, with a scale
                attack from round 1, chaos (dropout 0.2, straggler 0.1,
                crash 0.3, broadcast loss 0.1) and elastic membership
                (leave 0.1, join 0.3, preempt 0.05): per round the
                aggregator, crashed aggregator, rejected counters, members
                and generations, every verifying client rejecting the
                scaled broadcast, each body captured once across the
                churning chunks, then each round alone (wall, device-busy
                share) beside a clean engine's and round 1 of both in
                turns; (f) a kNN-scored fault round; (a) every hook built
                in with null specs bit-equal to the clean round, with the
                graphs' nodes hooks off and on; (c) round 1 cut to one
                epoch on the card and the CPU, the same masks; (d) a noise
                attack on the fused and the per-phase round; (e) 2 rounds
                with a snapshot resumed to 3 against 3 uninterrupted;
     cluster    (after the main path) clustered federation on the typed
                fleet (synthetic_typed_clients: 16 gateways of 4 device
                types at 115/27/7), the quick run, autoencoder / mse_avg:
                first the kernels at the clustered path's own shapes (the
                probe encode, the per-client verification, the routed
                2N-model verification = the uniform launch's bits, the
                cohort's train step, the kNN evaluation's distances);
                (b) run_combination with --cluster-k 4: the card's
                assignment equal to the CPU's fit from the same states,
                its purity against the types, every client that accepted
                the last broadcast holding its cluster's merge (<= 1e-6);
                (g) a kNN-scored clustered round; (a) ClusterSpec(k=1)
                bit-equal to no spec with the same graphs; (c)
                --cluster-personalize: cluster encoder + own post-training
                decoder, bit for bit; (d) with --elastic-join 0.3
                --elastic-leave 0.1 --chaos-dropout 0.2: every joiner its
                cluster's (or the fleet's) incumbent mean, checked on the
                host after each round (<= 1e-6); (e) round 1 at one epoch,
                card vs CPU (<= 1e-4); (f) --cluster-refit-every 1 with
                --resume-dir, resumed vs uninterrupted (<= 1e-6); then
                the clustered round timed in turns with the clean one
                (wall, busy share, nodes) and each fit's seconds;
     redteam    (after the main path) the red team's round half on the
                same typed fleet, autoencoder / mse_avg, clustered at
                K = 2: first the kernels at its shapes (the clustered
                path's cases); (d) the mimicry cell on the K = 2 fit over
                a grid of blends (its assignment pinned below); (b) a
                merge-stage cluster_poison (a lying voter elects its
                cluster-mate, sign_flip x2 on the victim cluster): the
                coalition's own rows -2x the clean round's, the other
                cluster's merge and clients bit-equal, the victim's merge
                the host's f64 merge poisoned (<= 1e-6); (g) that round
                kNN-scored; (a) RedteamSpec() bit-equal to no spec,
                single-global and clustered, the same graph nodes; (c)
                sybil under a join blitz, undefended and with min_tenure:
                every election replayed on the host; (e) round 1 at one
                epoch with a noise poison, card vs CPU (<= 1e-4);
     batch      (after the main path) --batch-runs on the quick run,
                hybrid / mse_avg: the kernels at the batched shapes (the
                train step at G = 15 and 40 with one run's CTAs per
                client, each run's rows its own launch's bits; the vote
                over R·N routed models; the distances over R·N banks);
                R = 3 batched through run_batched_combination against 3
                run_combination calls (the same selections, elections and
                stops, final AUC within 2e-3, the states' error reported;
                one train launch per step for all runs) and a kNN-scored
                batched round; round 1 at one epoch batched vs alone
                (<= 1e-5); the steady round of R = 3 runs, batched and
                one after another (wall, launches);
     tiered     (after the main path) the tiered state layout
                (--state-layout tiered), hybrid / mse_avg: the kernels at
                its shapes (the train step at G = 512, the forward over
                512 routed models, each also bit-equal to a second call);
                (a) the quick run at num_participants 1.0, the tiered
                engine against the dense fused engine bit for bit
                (states, results, the final evaluation; graph nodes
                printed); (b) at 0.5 the prefetched loop against the
                serial loop bit for bit, round 0's cohort curves the dense
                engine's, the other clients' metrics NaN; (c) 100,000 and
                10,000 bulk gateways (bench.py:1267's layout) at C = 512:
                a warm round and 3 timed ones, the tier's init seconds
                and host bytes, the prefetch gap and issue seconds, the
                main thread's steps, one slab's H2D, a round's device
                time, the host's peak RSS and MemAvailable, and the peak
                device bytes beside cohort_bytes(), which must agree
                within 5% across N; (d) the dense fused engine at 100,000
                gateways and C = 512 (the tie-break keyed: above the size
                rule at (C, N)), sec/round and peak device bytes,
                recorded; (f) the --podscale drivers' federation (8/6/3,
                100,000 bulk gateways, full participation, 2 rounds)
                with the vote tie-break on, above the tier's size rule:
                no [S, C] tie-break tensor on the host or the card, the
                peak device bytes within 5% of the same run with the
                tie-break off, the keyed row on the card the CPU's bits,
                and the keyed hash's device time at N; (g) the dense
                fused engine at 100,000 bulk gateways at 8/6/3, batch 16,
                full participation, a warm round and 2 timed ones with
                the tie-break on (keyed: no S x N buffer, the generator
                untouched, the card's row the CPU's bits) and off, peak
                device bytes within 1%, both kernels launched; then 3
                batched keyed runs of 10,000 gateways, each run's
                election the run's alone on the card;
     flywheel   (after the main path) the flywheel control loop
                (--flywheel) on the trained hybrid / mse_avg checkpoint:
                (a) the kernels at its shapes (the fine-tune's train step
                at G = 10 over 32 reservoir batches of 12, the routed
                candidate-scoring forward over 1,280 held-out rows, the
                bank refresh's encode of [10, 384, 115], a serving
                bucket's distances to 512-slot banks, each also bit-equal
                to a second call); (b) run_flywheel_smoke with the kNN and
                the centroid score (every interleaved test row, the shift
                1.5 feature-stds per feature): at least one swap, no ticket
                dropped, the served params the installed bits after every
                chunk and through every fine-tune; and two drift-recovery
                cells at the paper's width (drift_recovery_sweep.py's
                regime: hybrid / centroid and autoencoder / kNN), adapted
                AUC above the frozen engine's; (c) the first fine-tune cut
                to one epoch, card vs CPU (<= 1e-4); (d) the kNN pass with
                the fine-tune in the background (its graphs captured on
                the worker's thread while the front streams): rows served
                while it is pending, its params the synchronous
                fine-tune's bits from the same snapshot; (e) the
                slow-drift adversary walking gateway 0 against the live
                loop (its position and its target rows' normal share
                around each swap, reported);
     tune       (after the main path) the autotuner into a temporary cache
                file: tune_serve_ladder(max_bucket=1024, dim=115) and
                tune_tier_chunk() with every candidate's wall; a
                bucket_ladder="auto" engine serves the chosen ladder with
                the pow2 engine's bits over 8,192 rows (centroid and kNN;
                pow2_mid too), the tiered engine reads the tuned chunk, a
                tier at that chunk is the dense init's bits, and another
                device name misses;
     net        (after the main path) the network serving plane
                (--serve-net, net/): first the forward and distance
                kernels at the plane's shapes against their plain
                versions (10 routed models, buckets of 1 to 1,024 rows;
                the kNN buckets against 10 banks of 512); (a) the
                --serve-net path: the
                quick-run hybrid / mse_avg combination trained and
                checkpointed by run_combination, then run_net_smoke with
                the kNN score (512-slot banks, k = 8), 2 replicas (each on
                a CUDA stream of its own) and 8,192 interleaved rows in
                64-row bursts over localhost TCP with the mid-stream
                calibration swap (zero dropped, the statuses summing to
                the rows), then the same plane by hand through a
                NetClient: each scored row's score the bits of the port's
                own engine.score (that reference's launches not counted);
                (b) a worker process (`python -m
                fedmse_tpu_torch.net.server --replicas 1 --no-admission
                --seed 0`, spawned after the kernels were built) behind a
                RemoteReplica beside a LocalReplica of the same seed: the
                local replica's bits, a params swap reaching it as numpy,
                exit 0 on SIGTERM, the card's used memory with and without
                it; (c) calibrate_capacity at 1, 2 and 4 replicas (10
                gateways, max_batch 1024), then a 2-replica NetFront:
                one client's tier-0 stream at saturation, and open-loop
                streams at 0.5x and 2x the smaller of that and the probe
                over 3 tiers (nothing shed at 0.5x; at 2x rows shed, tier
                0 never, tier 2 most);
     gateway    (after the main path) the gateway ingest plane
                (gateway/): first the forward at the plane's shapes
                against its plain version (1,024 routed models, random
                and 64-row-session buckets to 1,024 rows, the engines'
                fit over 512 rows a gateway); (a)
                build_synthetic_frontend(n_gateways=1024, dim=115,
                replicas=2): an unknown gateway, a bad MAC and a bad
                token each rejected with rows_parsed 0, then 1,024
                sessions over 16 connections, one 64-row burst each, sent
                all at once and again paced at half that rate, the
                verdicts and scores the bits of a direct Router over
                build_synthetic_replicas of the same seed; (b) a stripe
                member dying mid-flight loses no admitted ticket; (c)
                handshakes/s, the flood's rows/s (with the frontend and
                client threads' CPU shares) and the paced stream's p99 as
                [watch] lines;
     parallel   (after the main path) the client mesh (parallel/): (a) a
                one-rank NCCL group (multihost.initialize with a
                FileStore): the quick run (10 gateways, hybrid / mse_avg,
                the tie-break off) over the world-1 mesh the plain run's
                bits (elections, every round's metrics, params, the final
                evaluation) and graphs (nodes, one stretch each), the exact collective merge the dense merge's
                bits on CUDA tensors and the one-group quantized merge the
                exact one's, plan_merge's walls; (b)-(d) two rank processes
                on the one card over gloo (parallel/launch.py spawning
                chip_smoke.parallel_rank, after the kernels were built):
                (b) the quick run's 10 gateways, 5 a rank, under shard_map
                and quantized (2 groups): both ranks the same bits, the
                dense card run's elections, round-1 params within 1e-6
                scaled and the final AUC within 2e-3, the quantized merge
                within its codec bound of the exact one on the trained
                states, forward and train launched on each rank, the
                card's used memory with both ranks up, plan_merge's walls
                on the 2 ranks; (c) the host-sharded tier at 10,000 bulk
                gateways, C = 512, 2 rounds: the ranks equal, each tiering
                its 5,000 rows (half the host bytes), the AUC within 2e-3
                of one process replaying the same cohorts; (d) the 10
                gateways' kNN engine gateway-sharded over the 2 ranks: the
                unsharded engine's bits over 8,192 rows; (e) the quick
                run through the per-phase engine with profile=True and
                the kNN score (shard_map) on the same 2 ranks: both ranks
                the same bits, the dense per-phase card run's and (b)'s
                elections, round-1 params (b)'s bits and within 1e-6
                scaled of the dense per-phase run's, the final AUC within
                2e-3 of it, every round's five phase seconds per rank,
                all three kernels launched on each rank; then, on each
                rank, the train step, the forward and the distances at
                that rank's shapes (those of (b) and (e): one block)
                against their plain versions;
     realdata   (after the main path, before parallel) the real-data
                pipeline: a raw tree in N-BaIoT's layout (9 devices, 115
                features, a header line on every file; 27,900 benign and
                32,040 attack rows, the published split's pool when every
                row is sampled) written from the port's generator;
                `python -m fedmse_tpu_torch.data.prep` from it (--raw,
                non-IID alpha 0.5 over 10 clients, every row) and from
                those shards (--source --target-matrix --cluster-labels
                9, its k-means on the card), each with its wall and JS
                distances; every shard of both trees parsed by the host
                reader (csrc/fedmse_io.cpp, built with the kernels) and by
                np.loadtxt, the same float64 bits, each route's MB/s;
                `main --dataset-config` on the published-split shards (the
                quick run, hybrid / mse_avg) and a kNN-scored evaluation
                of its checkpoint: the final mean AUC above 0.9; the round
                results loaded and plotted (an ImportError naming
                matplotlib where it is absent) and the provenance logged;
                then the kernels at the path's shapes (the forward over
                10 models at the evaluation's rows, the train step at the
                round's G and R, the distances at its test rows);
     sweeps     (after the main path, after parallel) the threat-model
                sweep drivers (attack_sweep_torch.py, chaos_sweep_torch.py,
                churn_sweep_torch.py, redteam_sweep_torch.py) at reduced
                grids: first the train step and the forward at the
                sweeps' cohort widths (G = 100, 200) against their plain
                versions; (a) the attack sweep's baseline and scale-10
                cells in both verifier modes, 4 rounds (the baseline
                accepts every broadcast, every client with a history
                rejects scale 10); (b) the chaos sweep's (0, 0) cell, the
                clean engine's bits, and both burst rows (rounds_to_recover
                finite); (c) the churn sweep's capture-once pin cut from
                10,000 clients and C = 200 to 64 and 8 (each CUDA graph
                body captured once across churning chunks, null churn the
                static round's bits); (d) the red team's quick cell;
     padding    (after the main path, after the studies) padding the
                client axis trains the unpadded federation: (a) the 10
                gateways' fused quick run through run_combination,
                unpadded and padded to 12, tie-break on, scored by kNN:
                the same selections, elections, verification rows and
                stop, the real params bit for bit or within 1e-6 per leaf
                scale-normalized, the same final AUC; (b) the same on the
                per-phase round; (c) 9 gateways (N-BaIoT's devices) on 2
                gloo ranks of the one card, padded to 10
                (chip_smoke.padding_rank), against the dense 9-gateway
                per-phase run, tie-break off as in [parallel]: the same
                elections, round-1 params within 1e-6, the final AUC
                within 2e-3; (d) the three kernels at
                the padded shapes (G = 12, each rank's block) against
                their plain versions;
     kitnet     (after the main path, after padding) KitNET
                (models/kitnet.py): (a) main.run_combination with
                model_type 'kitnet', scaler minmax, fedprox, on the fused,
                pipelined schedule over 40 gateways in N-BaIoT's layout
                (23 statistics x 5 windows), every launch counter set to
                0 just before and read just after: the KitNET kernels and
                the update launched, the update once a train step, the
                autoencoder's kernels never; final AUC above 0.9; (b)
                both KitNET kernels against their plain twins (TF32 off)
                under the run's feature map, at the train steps of 250
                and 5 clients of 12 rows and at the 500-gateway cell's
                evaluation forward (500 models x 3,000 rows), within
                1e-5 scale-normalized (the statistics within 1e-6), one
                launch a call, timed per call in a 16-call graph over 16
                input sets beside the bound of
                benchmark/roofline_kitnet.py;
  6. card-cpu   one combination's first round, cut to one epoch, on the
                card and on the CPU (the plain versions) from one init;
  7. report     kernel time (per wrapper call by CUDA events; per replay
                of the call's one-call CUDA graph by CUDA events around
                back-to-back replays, a reading below the kernel's bound
                flagged and not taken; and, as a cross-check only, the
                kernel's own device time by torch.profiler), plain-version
                time, library time where one PyTorch call computes the
                same function, and bound at the main path's shapes (the
                forward also at the training path's own launches; the
                distance kernel beside its predecessor, built from
                csrc/dist_tiles_baseline.cu, whose bits it reproduces, and
                inside the kNN score it starts, with a one-element fill
                as the floor of a launch), and
                one more training round on each path, fused and
                per-phase, timed and under the profiler (wall, device
                busy share, device ms per train step; for the fused round
                its host reads, graph replays, capture seconds and nodes),
                and 12 fused rounds in chunks of 2 with the chunk loop
                pipelined and serial (--no-pipeline): wall per round,
                the same final bits.

PERF.md's speed limits (served rows/s, verdict p99, round wall) are logged
as "[watch]" lines beside their limits and listed under "watched" in the
kernels line; they are not asserted (host-clock rates move 35-80% between
calls on the same code).

Phases 3 to 5 are the main path: the kernels' launch counters are set to 0
just before them and read just after, and each kernel must have launched
there. The robust phase's (b) and (f) are the fault path, read the same
way ("fault_path_launches" in the kernels line), the cluster phase's
(b) and (g) the clustered path ("cluster_path_launches"), the redteam
phase's (b) and (g) the red path ("redteam_path_launches") and the batch
phase's batched run and kNN round the batched path
("batch_path_launches"), the tiered phase's tiered engines (not the
dense engines they are held to) the tiered path
("tiered_path_launches"), the flywheel phase's (b) the flywheel path
("flywheel_path_launches"), the net phase's (a) the --serve-net path
("net_path_launches"), the gateway phase's (a) the gateway path
("gateway_path_launches"), the parallel phase's meshed runs in (a)
to (e) (not the plain runs they are held to), summed over this process
and the two ranks, the parallel path ("parallel_path_launches"), and
the realdata phase's training run and kNN evaluation the real-data path
("realdata_path_launches"), and the sweeps phase's driver calls (a) to
(d) the sweep path ("sweep_path_launches"; no sweep scores by kNN, so
the distance kernel's count there is 0), and the padding phase's padded
runs in (a) to (c), summed over this process and the two ranks, the
padded path ("padding_path_launches"). A launch
inside a replayed CUDA graph counts: each graph keeps the kernels it
captured, and each replay adds them (ops/graphs.py). Prints,
as its last three lines, the card's name and power limit, one JSON line
of kernel numbers, and {"ok": true, "device": {...}}. Any
failure raises and exits non-zero with no result line; so does a machine
without CUDA (exit 2). A failure before the [device] line (an import, the
config, nvidia-smi: e.g. the script run alone, without the package)
prints "[error] <stage>: <cause>" and its traceback on stdout first.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DIMS = (115, 27, 7)  # the paper's width: ExperimentConfig's defaults
# scale-normalized tolerances (max |kernel - plain| / max |plain| per output)
# f32: the kernel and the plain version differ in summation order only.
# bf16: activations round to bf16 between layers; a last-bit difference in
# an f32 sum can round an activation one bf16 ulp (2**-8 relative) the
# other way, and four ulps cover such a flip carried through later layers.
TOL = {"f32": 1e-5, "bf16": 2.0 ** -6}
# the distance kernel's math is f32 in both dtypes (bf16 queries upcast
# exactly): summation order only
DIST_TOL = 1e-5
KNN = dict(knn_bank_size=512, knn_k=8)  # ExperimentConfig's kNN defaults
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 outside the tensor
# cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


# PERF.md section 2's speed limits. They are watched, not asserted: these
# rates and latencies are taken on the host's clock, which moves them by
# 35-80% between calls on the same code (a one-card machine shares its
# host's cores), so a limit would fail on a slow host, not on slow code.
WATCHED = []


def watched(what: str, value: float, limit: float, at_least: bool) -> None:
    """Log a watched value beside its limit and keep it for the report."""
    within = value >= limit if at_least else value <= limit
    WATCHED.append({"what": what, "value": value, "limit": limit,
                    "at_least": at_least, "within": within})
    log(f"[watch] {what}: {value:.6g}, watched limit "
        f"{'>=' if at_least else '<='} {limit:g} "
        f"({'within' if within else 'outside'}; not asserted)")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def scaled_err(got, want) -> float:
    if want.numel() == 0:
        return 0.0
    diff = (got.double() - want.double()).abs().max().item()
    return diff / max(want.double().abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls after a warm-up,
    by CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# calls in the graph whose replays time a kernel with a replay's launch
# gap spread over them (a one-call graph's replay of a one-element fill
# reads ~0.012 ms on an H100, above the train kernel's time)
GRAPH_CALLS = 16


def graph_ms(torch, fn, device, reps: int, calls: int = 1) -> float:
    """Mean device milliseconds per call of fn() over `reps` replays, back
    to back, of a CUDA graph of `calls` calls (ops/graphs.CapturedBody;
    calls = 1 is the graph kernels_of_one_call counts), by CUDA events
    around the replays: the call's kernels and copies with a replay's
    launch gap over `calls`, and no profiler."""
    from fedmse_tpu_torch.ops.graphs import CapturedBody

    def body_fn():
        for _ in range(calls):
            fn()
    body = CapturedBody(body_fn, device, "timed calls")
    for _ in range(3):  # the eager warm-up and capture, then replays
        body()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        body()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def graph_time(torch, fn, device, reps: int, bound_ms: float) -> dict:
    """A kernel's times from graph replays (graph_ms): "graph_ms" per
    replay of its one-call graph, "graph_ms_calls" per call in a graph
    of GRAPH_CALLS calls (the time of record). A reading below the
    kernel's bound (no valid time can be) is flagged under
    "<key>_below_bound" and its key is None."""
    out = {}
    for key, calls in (("graph_ms", 1), ("graph_ms_calls", GRAPH_CALLS)):
        ms = graph_ms(torch, fn, device, reps, calls)
        if ms < bound_ms:
            out[key], out[f"{key}_below_bound"] = None, ms
        else:
            out[key] = ms
    return out


def _graph_text(g: dict) -> str:
    def one(key):
        if g[key] is not None:
            return f"{g[key]:.5f} ms"
        return (f"{g[key + '_below_bound']:.5f} ms, BELOW its bound: not "
                f"taken")
    return (f"{one('graph_ms')}, per call in a graph of {GRAPH_CALLS} "
            f"{one('graph_ms_calls')}")


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds per call of the CUDA kernels whose name
    contains `kernel`, from torch.profiler over `reps` calls (the kernel's
    own time, without the host's time between launches); NaN when the
    profiler records no device time in two tries (it has dropped a whole
    window's device events once on an H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(_device_us(e) for e in prof.key_averages()
                    if kernel in e.key)
        if total > 0:
            return total / 1e3 / reps
    return float("nan")


def all_device_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call of every CUDA kernel and copy that
    fn() runs, from torch.profiler over `reps` calls; NaN when the profiler
    records no device event in three tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return float("nan")


def json_line(obj) -> str:
    """One line of strict JSON: a number that is not finite (a device time
    the profiler did not record) becomes null."""
    def clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v
    return json.dumps(clean(obj))


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value:
            return float(value)
    return 0.0


def bound(rows: int, models: int, precision: str, dims=DIMS):
    """Least time (ms) for the fused forward's work on an H100: FLOPs of the
    four matmuls over the peak for the input type, or the bytes it must
    move (x, model index and outputs once, every used model's weights once)
    over HBM bandwidth, whichever is larger."""
    d, h, lat = dims
    esize = 2 if precision == "bf16" else 4
    macs = d * h + h * lat + lat * h + h * d
    flops = 2.0 * macs * rows
    nbytes = (rows * (d * esize + 4 + 4 * (lat + 2))
              + min(models, rows) * (macs * esize + 4 * (2 * h + lat + d)))
    t_ops, t_bytes = flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def random_params(torch, g, d, h, lat, gen, device, cdt):
    from fedmse_tpu_torch.ops.precision import cast_params

    def dense(i, o):
        return {"kernel": (torch.rand((g, i, o), generator=gen) * 2 - 1)
                / i ** 0.5,
                "bias": torch.randn((g, o), generator=gen) * 0.1}
    tree = {"encoder": {"Dense_0": dense(d, h), "Dense_1": dense(h, lat)},
            "decoder": {"Dense_0": dense(lat, h), "Dense_1": dense(h, d)}}
    return {c: {n: {k: v.to(device) for k, v in layer.items()}
                for n, layer in coder.items()}
            for c, coder in cast_params(tree, cdt).items()}


def grid_params(torch, g, d, h, lat, gen, device, cdt):
    """Stacked forward params with weights and biases in Z/16, |v| <= 1/4:
    with x in Z/4, |x| <= 1.5, every sum of the forward up to its last ReLU
    gate is exact in f32 at widths up to the paper's, whatever its order."""
    from fedmse_tpu_torch.ops.precision import cast_params

    def grid(shape):
        return torch.randint(-4, 5, shape, generator=gen) / 16.0

    def dense(i, o):
        return {"kernel": grid((g, i, o)), "bias": grid((g, o))}
    tree = {"encoder": {"Dense_0": dense(d, h), "Dense_1": dense(h, lat)},
            "decoder": {"Dense_0": dense(lat, h), "Dense_1": dense(h, d)}}
    return {c: {n: {k: v.to(device) for k, v in layer.items()}
                for n, layer in coder.items()}
            for c, coder in cast_params(tree, cdt).items()}


def forward_index(torch, kind, g, rows, gen, device):
    """A forward launch's model index: None (every row model 0),
    client-major (the evaluator's, the vote's and validation's layout: g
    equal runs, boundaries mid-tile where rows / g is not a multiple of the
    tile) or random (a routed serving bucket)."""
    if kind == "none":
        return None
    if kind == "client_major":
        idx = torch.arange(g, dtype=torch.int32).repeat_interleave(
            -(-rows // g))[:rows]
    else:
        idx = torch.randint(0, g, (rows,), generator=gen, dtype=torch.int32)
    return idx.to(device)


def phase_kernels(torch, device):
    """The forward kernel vs its plain version at every listed shape, dtype
    and index layout, each case also bit-equal to a second call; then one
    CUDA kernel per call at the main path's shapes.

    The f32 cases run on dyadic grids (grid_params, x in Z/4): with
    arbitrary floats a pre-activation within rounding of 0 takes its ReLU
    gate one way in one summation order and the other way in another (a
    tie of the function, PR 5); on the grids every gate is decided exactly.
    The bf16 cases keep arbitrary floats; their tolerance covers a flipped
    bf16 rounding between layers."""
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    gen = torch.Generator().manual_seed(SEED)
    worst = {p: {"abs": 0.0, "scaled": 0.0} for p in TOL}
    checked = 0
    # (dims, models, rows, index kinds): a grid of both widths, every row
    # count under random routing (G = 512, R = 1024 is the 512-gateway
    # serving bucket) and, in turn, client-major or no index; then the main
    # path's own launches, client-major at the paper's width: the
    # evaluation (10 x 7,008 rows: 64-row tiles, boundaries mid-tile),
    # validation (5 x 1,008), the vote (10 x 1,000), mse_avg's dev scoring
    # (5 x 40,000), and a 1,001-row client layout with a partial last tile
    cases = [(dims, g, rows, ("random", ("client_major", "none")[i % 2]))
             for dims in (DIMS, (37, 9, 3)) for g in (1, 10, 512)
             for i, rows in enumerate((0, 1, 7, 256, 1024, 70_000))]
    cases += [(DIMS, 10, 70_080, ("client_major", "random")),
              (DIMS, 5, 5_040, ("client_major",)),
              (DIMS, 10, 10_000, ("client_major",)),
              (DIMS, 5, 200_000, ("client_major",)),
              (DIMS, 3, 3_003, ("client_major",)),
              ((128, 128, 126), 2, 4_100, ("client_major", "random"))]
    for dims, g, rows, case_kinds in cases:
        for precision, cdt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16)):
            if precision == "f32":
                params = grid_params(torch, g, *dims, gen, device, cdt)
                x = (torch.randint(-6, 7, (rows, dims[0]), generator=gen)
                     / 4.0).to(device)
            else:
                params = random_params(torch, g, *dims, gen, device, cdt)
                x = (torch.randn((rows, dims[0]), generator=gen)
                     * 1.5).to(device=device, dtype=cdt)
            for kind in case_kinds:
                idx = forward_index(torch, kind, g, rows, gen, device)
                got = fused_forward_stats(params, x, idx, compute_dtype=cdt)
                again = fused_forward_stats(params, x, idx,
                                            compute_dtype=cdt)
                want = fused_forward_stats_plain(params, x, idx,
                                                 compute_dtype=cdt)
                torch.cuda.synchronize()
                what = f"dims={dims} {precision} G={g} R={rows} {kind}"
                for name, a, a2, b in zip(("latent", "mse", "znorm"),
                                          got, again, want):
                    if a.shape != b.shape or a.dtype != torch.float32:
                        raise AssertionError(f"{name} shape/dtype "
                                             f"{a.shape} {a.dtype}")
                    if rows and not torch.isfinite(a).all():
                        raise AssertionError(f"{name} not finite {what}")
                    if not torch.equal(a.view(torch.int32),
                                       a2.view(torch.int32)):
                        raise AssertionError(f"forward kernel {what}: two "
                                             f"calls differ in {name}")
                    err = scaled_err(a, b)
                    if err > TOL[precision]:
                        raise AssertionError(
                            f"kernel vs plain {name} {what}: scaled error "
                            f"{err:.3e} > {TOL[precision]:.1e}")
                    w = worst[precision]
                    w["scaled"] = max(w["scaled"], err)
                    if rows:
                        w["abs"] = max(w["abs"], (a - b).abs().max()
                                       .item())
                checked += 1
    for g, rows, kind, cdt in ((10, 70_080, "client_major", torch.float32),
                               (10, 70_080, "client_major", torch.bfloat16),
                               (10, 256, "random", torch.float32),
                               (512, 1024, "random", torch.float32)):
        params = random_params(torch, g, *DIMS, gen, device, cdt)
        x = torch.randn((rows, DIMS[0]), generator=gen).to(device, cdt)
        idx = forward_index(torch, kind, g, rows, gen, device)
        nodes, ran = kernels_of_one_call(torch, lambda: fused_forward_stats(
            params, x, idx, compute_dtype=cdt), device)
        if nodes != 1 or ran != {"fused_ae_forward": 1}:
            raise AssertionError(f"one forward at G={g} R={rows} ran {nodes} "
                                 f"graph nodes, kernels {ran}, not one "
                                 "fused_ae_forward_kernel")
    log(f"[kernels] {checked} kernel-vs-plain cases agree, each bitwise "
        f"equal to a second call; one CUDA kernel per call at the "
        f"evaluation and both serving buckets; worst {json.dumps(worst)}")
    return worst


def train_flops_per_row(dims=DIMS) -> int:
    """Forward 2(DH + HL + LH + HD) plus backward 2(2HD + 2LH + 2HL + DH)."""
    d, h, lat = dims
    return 2 * (d * h + h * lat + lat * h + h * d) \
        + 2 * (2 * h * d + 2 * lat * h + 2 * h * lat + d * h)


def train_bound(rows: int, clients: int, precision: str, dims=DIMS):
    """Least time (ms) for the fused train step's work on an H100: its
    FLOPs over the peak for the input type, or the bytes it must move (x
    and the mask once, each client's f32 parameters read once and its P
    f32 gradients and its loss written once) over HBM bandwidth."""
    d, h, lat = dims
    esize = 2 if precision == "bf16" else 4
    p = 2 * d * h + 2 * h * lat + 2 * h + lat + d
    flops = float(train_flops_per_row(dims)) * rows * clients
    nbytes = clients * (rows * (d * esize + 4) + 4 * p + 4 * (p + 1))
    t_ops, t_bytes = flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def random_flat(torch, layout, g, gen, device):
    """[G, P] f32 parameters: U(+-1/sqrt(fan_in)) kernels, N(0, 0.1) biases."""
    flat = torch.empty((g, layout.size))
    for sl, (path, _, shape) in zip(layout.slices(), layout.leaves()):
        n = sl.stop - sl.start
        if path[-1] == "kernel":
            flat[:, sl] = (torch.rand((g, n), generator=gen) * 2 - 1) \
                / shape[0] ** 0.5
        else:
            flat[:, sl] = torch.randn((g, n), generator=gen) * 0.1
    return flat.to(device)


def kernels_of_one_call(torch, fn, device) -> tuple:
    """(nodes, {wrapper name: kernels}) of one call of fn() captured into
    a CUDA graph by ops/graphs.CapturedBody, after its eager warm-up call:
    every kernel, copy and memset the call issues on its stream is a node
    of the graph (read through the driver, cuGraphGetNodes), and each
    wrapper counts the kernels of its own that the capture recorded. Not
    torch.profiler: an H100 has dropped a whole window's device events
    three times in a row, and the graph's nodes do not depend on it."""
    from fedmse_tpu_torch.ops.graphs import CapturedBody
    body = CapturedBody(fn, device, "one call")
    body()
    if body.nodes is None:
        raise AssertionError("this torch keeps no captured graph, so the "
                             "nodes of one call cannot be counted")
    return body.nodes, dict(body.kernels)


def grid_inputs(torch, layout, g, rows, gen, device):
    """[G, P] parameters in Z/16 with |v| <= 1/4 and x [G, R, D] in Z/4 with
    |x| <= 1.5, f32: on these grids every sum of the forward up to the ReLU
    gates is exact in f32 whatever its order, so two correct summation
    orders decide every gate alike."""
    flat = torch.randint(-4, 5, (g, layout.size), generator=gen) / 16.0
    x = torch.randint(-6, 7, (g, rows, layout.dim), generator=gen) / 4.0
    return flat.to(device), x.to(device)


def phase_train_kernels(torch, device):
    """The train kernel vs its plain version: G in {1, 5, 133, 512} (8, 8, 1
    and 1 CTAs per client at H = 27), R in {0, 1, 12, 129, 200, 1008} (every
    R one launch: the cluster walks its row tiles), widths 115/27/7 and
    37/9/3 (hidden units split unevenly over the CTAs) and 16/3/2 (H < 8:
    clusters of 3), both dtypes, lambda in {0, 10}, with masked rows and
    (G > 1) an all-masked client, whose loss and grads must be NaN on both.
    Every case runs the kernel twice and the two results must be equal bit
    for bit; one call at the main path's step and at 1,008 rows must run
    exactly one CUDA kernel.

    The f32 cases run on grid_inputs. With arbitrary floats a pre-activation
    within rounding of 0 takes its ReLU gate one way in one summation order
    and the other way in another, and moves the gradients by ~1e-3 (seen at
    G = 512, R = 1,008: 28M gates): a tie of the function, which neither
    order gets wrong. On the grids the forward is exact and the gates agree,
    so 1e-5 holds what it is meant to hold, the backward's rounding. The
    bf16 cases keep arbitrary floats, so that the weights' rounding at load
    is exercised; their tolerance covers a flipped gate."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 3)
    worst = {p: {"abs": 0.0, "scaled": 0.0} for p in TOL}
    checked = 0
    for dims in (DIMS, (37, 9, 3), (16, 3, 2)):
        layout = ParamLayout(*dims)
        for precision, cdt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16)):
            for g in (1, 5, 133, 512):
                for rows in (0, 1, 12, 129, 200, 1008):
                    if precision == "f32":
                        flat, x = grid_inputs(torch, layout, g, rows, gen,
                                              device)
                    else:
                        flat = random_flat(torch, layout, g, gen, device)
                        x = (torch.randn((g, rows, dims[0]), generator=gen)
                             * 1.5).to(device=device, dtype=cdt)
                    m = (torch.rand((g, rows), generator=gen) < 0.85).float()
                    if g > 1:
                        m[-1] = 0.0
                    m = m.to(device)
                    for lam in (0.0, 10.0):
                        kw = dict(layout=layout, shrink_lambda=lam,
                                  compute_dtype=cdt)
                        got = fused_train_grads(flat, x, m, **kw)
                        again = fused_train_grads(flat, x, m, **kw)
                        want = fused_train_grads_plain(flat, x, m, **kw)
                        torch.cuda.synchronize()
                        what = (f"dims={dims} {precision} G={g} R={rows} "
                                f"lam={lam}")
                        for a, b in zip(got, again):
                            if not torch.equal(a.view(torch.int32),
                                               b.view(torch.int32)):
                                raise AssertionError(f"train kernel {what}: "
                                                     "two calls differ")
                        live = m.sum(dim=1) > 0
                        for name, a, b in zip(("loss", "grads"), got, want):
                            if a.dtype != torch.float32 or a.shape != b.shape:
                                raise AssertionError(f"train {name} shape/"
                                                     f"dtype {a.shape}")
                            if not (torch.isnan(a[~live]).all()
                                    and torch.isnan(b[~live]).all()):
                                raise AssertionError(
                                    f"train {name}: an all-masked client "
                                    "must give NaN")
                            a, b = a[live], b[live]
                            if not torch.isfinite(a).all():
                                raise AssertionError(f"train {name} not "
                                                     "finite")
                            err = scaled_err(a, b)
                            if err > TOL[precision]:
                                raise AssertionError(
                                    f"train kernel vs plain {name} {what}: "
                                    f"scaled error {err:.3e} > "
                                    f"{TOL[precision]:.1e}")
                            w = worst[precision]
                            w["scaled"] = max(w["scaled"], err)
                            if a.numel():
                                w["abs"] = max(w["abs"], (a - b).abs().max()
                                               .item())
                        checked += 1
    layout = ParamLayout(*DIMS)
    for g, rows in ((5, 12), (1, 1008)):
        flat = random_flat(torch, layout, g, gen, device)
        x = torch.randn((g, rows, DIMS[0]), generator=gen).to(device)
        m = torch.ones((g, rows), device=device)
        nodes, ran = kernels_of_one_call(torch, lambda: fused_train_grads(
            flat, x, m, layout=layout, shrink_lambda=10.0), device)
        if nodes != 1 or ran != {"fused_ae_train": 1}:
            raise AssertionError(f"one train step at G={g} R={rows} ran "
                                 f"{nodes} graph nodes, kernels {ran}, not "
                                 "one fused_ae_train_kernel")
    log(f"[kernels] {checked} train-kernel-vs-plain cases agree, each "
        f"bitwise equal to a second call; one CUDA kernel per call at "
        f"R = 12 and 1008; worst {json.dumps(worst)}")
    return worst


def dist_bound(rows: int, bank: int, banks_read: int, lat: int = DIMS[2]):
    """Least time (ms) for the distance tiles on an H100: the cross term's
    2 L T B f32 FLOPs over the f32 peak, or the bytes (the [T, B] f32
    output written once, q [T, L] and the bank index [T] read once, each
    distinct bank [B, L] read once) over HBM bandwidth."""
    flops = 2.0 * lat * rows * bank
    nbytes = 4.0 * (rows * bank + rows * (lat + 1) + banks_read * bank * lat)
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main_dist_shapes(eval_rows):
    """(what, banks N, rows T, bank-index kind) of the distance launches on
    the main path, each against 512-slot banks at L = 7."""
    return (("evaluate, 10 gateways", 10, eval_rows, "client_major"),
            ("serve bucket, 10 gateways", 10, 256, "random"),
            ("serve bucket, 512 gateways gather", 512, 1024, "random"))


def dist_inputs(torch, n, rows, bank, lat, gw_kind, gen, device, cdt):
    """Queries (bf16 or f32), f32 banks with ragged zeroed tails, and the
    bank index: absent, client-major (the evaluator's) or random (a
    serving bucket's)."""
    q = (torch.randn((rows, lat), generator=gen) * 1.5).to(device, cdt)
    banks = torch.randn((n, bank, lat), generator=gen)
    count = torch.randint(0, bank + 1, (n,), generator=gen)
    banks[torch.arange(bank)[None, :] >= count[:, None]] = 0.0
    gw = None
    if gw_kind == "client_major":
        gw = torch.arange(n, dtype=torch.int32).repeat_interleave(
            -(-rows // n))[:rows]
    elif gw_kind == "random":
        gw = torch.randint(0, n, (rows,), generator=gen, dtype=torch.int32)
    return q, banks.to(device), None if gw is None else gw.to(device)


def dist_check(torch, q, banks, gw, what):
    """One distance launch against its plain version on the same inputs;
    raises past DIST_TOL. Returns (kernel output, abs error, scaled
    error)."""
    from fedmse_tpu_torch.knn.score import dist_tiles, dist_tiles_plain
    got = dist_tiles(q, banks, gw)
    want = dist_tiles_plain(q, banks, gw)
    torch.cuda.synchronize()
    if got.shape != (q.shape[0], banks.shape[1]) or \
            got.dtype != torch.float32:
        raise AssertionError(f"dist {what}: shape/dtype {got.shape}")
    if not torch.isfinite(got).all() or (got < 0).any():
        raise AssertionError(f"dist {what}: distances not finite and >= 0")
    err = scaled_err(got, want)
    if err > DIST_TOL:
        raise AssertionError(f"dist kernel vs plain {what}: scaled error "
                             f"{err:.3e} > {DIST_TOL:.1e}")
    return got, (got - want).abs().max().item(), err


def phase_dist_kernels(torch, device, eval_rows):
    """The distance kernel vs its plain version: every (N, T, B) of N in
    {1, 10, 512}, T in {1, 17, 256, 1024, 30000}, B in {1, 8, 100, 512,
    1024}, cycling through f32 / bf16 queries, the three bank-index kinds
    and L in {7, 3, 16} (16 takes the kernel's streamed path), then the
    main path's three shapes at L = 7 in both dtypes: the evaluation
    (`eval_rows` client-major rows, 10 banks of 512) and the serving
    buckets (256 rows over 10 banks, 1024 rows over 512 banks, random
    routing). 81 cases, each also bit-equal to a second call. Then, at the
    main path's shapes in both dtypes, one CUDA kernel per call (bf16
    queries are upcast inside it), and the evaluation's rows permuted with
    their bank index (each row then loads its bank, as a routed bucket's
    does) give the client-major rows' bits."""
    from fedmse_tpu_torch.knn.score import dist_tiles
    gen = torch.Generator().manual_seed(SEED + 6)
    kinds = ("none", "client_major", "random")
    cases = []
    for n in (1, 10, 512):
        for rows in (1, 17, 256, 1024, 30_000):
            for bank in (1, 8, 100, 512, 1024):
                i = len(cases)
                cases.append((n, rows, bank, (7, 3, 16)[(i // 6) % 3],
                              ("f32", "bf16")[i % 2], kinds[(i // 2) % 3]))
    for _, n, rows, gw_kind in main_dist_shapes(eval_rows):
        for precision in ("f32", "bf16"):
            cases.append((n, rows, KNN["knn_bank_size"], DIMS[2], precision,
                          gw_kind))
    worst = {p: {"abs": 0.0, "scaled": 0.0} for p in TOL}
    for n, rows, bank, lat, precision, gw_kind in cases:
        cdt = torch.bfloat16 if precision == "bf16" else torch.float32
        q, banks, gw = dist_inputs(torch, n, rows, bank, lat, gw_kind, gen,
                                   device, cdt)
        what = (f"N={n} T={rows} B={bank} L={lat} {precision} "
                f"gw={gw_kind}")
        got, abs_err, err = dist_check(torch, q, banks, gw, what)
        if not torch.equal(dist_tiles(q, banks, gw).view(torch.int32),
                           got.view(torch.int32)):
            raise AssertionError(f"dist {what}: a second call differs")
        w = worst[precision]
        w["scaled"] = max(w["scaled"], err)
        w["abs"] = max(w["abs"], abs_err)
    for what, n, rows, gw_kind in main_dist_shapes(eval_rows):
        for cdt in (torch.float32, torch.bfloat16):
            q, banks, gw = dist_inputs(torch, n, rows, KNN["knn_bank_size"],
                                       DIMS[2], gw_kind, gen, device, cdt)
            nodes, ran = kernels_of_one_call(
                torch, lambda: dist_tiles(q, banks, gw), device)
            if nodes != 1 or ran != {"dist_tiles": 1}:
                raise AssertionError(f"dist {what} {cdt}: one call ran "
                                     f"{nodes} graph nodes, kernels {ran}")
            if gw_kind != "client_major":
                continue
            perm = torch.randperm(rows, generator=gen).to(device)
            routed = dist_tiles(q[perm].contiguous(), banks,
                                gw[perm].contiguous())
            if not torch.equal(routed.view(torch.int32),
                               dist_tiles(q, banks, gw)[perm]
                               .view(torch.int32)):
                raise AssertionError(f"dist {what} {cdt}: routed rows "
                                     "differ from client-major rows")
    log(f"[kernels] {len(cases)} dist-kernel-vs-plain cases agree, each "
        f"bitwise equal to a second call; one CUDA kernel per call in f32 "
        f"and bf16 at the main path's shapes; routed = client-major bits "
        f"at the evaluation; worst {json.dumps(worst)}")
    return worst


def phase_evaluate(torch, device, cfg, clients):
    """Both model types x both precisions over the 10-gateway federation,
    each with its own score and with the kNN score (exact and approximate
    top-k); every kNN evaluation is one distance launch."""
    from fedmse_tpu_torch.data import stack_clients
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.knn import dist_tiles
    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    dev_x = np.concatenate([c.dev_raw[:100] for c in clients]).astype(
        np.float32)
    results, knn_report = {}, {}
    for model_type in ("autoencoder", "hybrid"):
        aucs = {}
        for precision in ("f32", "bf16"):
            model = make_model(model_type, *DIMS,
                               shrink_lambda=cfg.shrink_lambda,
                               precision=precision, device=device)
            params = init_stacked_params(
                model, len(clients), torch.Generator().manual_seed(SEED),
                device=device)
            data = stack_clients(clients, dev_x, cfg.batch_size,
                                 dtype=model.compute_dtype, device=device)
            args = (data.test_x, data.test_m, data.test_y, data.train_xb,
                    data.train_mb)
            for score in ("own", "knn/exact", "knn/approx"):
                kw = ({} if score == "own" else
                      dict(score_kind="knn", knn_topk=score[4:], **KNN))
                before = fused_forward_stats.launches
                before_dist = dist_tiles.launches
                t0 = time.perf_counter()
                auc = make_evaluate_all(model, model_type, **kw)(params,
                                                                 *args)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launched = fused_forward_stats.launches - before
                dist_launched = dist_tiles.launches - before_dist
                if launched < 1:
                    raise AssertionError("evaluation did not launch the "
                                         "kernel")
                if dist_launched != (0 if score == "own" else 1):
                    raise AssertionError(f"{score} evaluation launched the "
                                         f"distance kernel {dist_launched}"
                                         " times")
                if auc.shape != (len(clients),) or \
                        not torch.isfinite(auc).all():
                    raise AssertionError(f"AUC not finite: {auc}")
                aucs[(score, precision)] = auc.cpu().numpy()
                rows = data.test_x.shape[0] * (
                    data.test_x.shape[1]
                    + (data.train_xb.shape[1] * data.train_xb.shape[2]
                       if model_type == "hybrid" or score != "own" else 0))
                log(f"[evaluate] {model_type} {score} {precision}: "
                    f"{launched} forward + {dist_launched} distance "
                    f"launch(es) over {rows} rows in {secs * 1e3:.3f} ms; "
                    f"per-client AUC "
                    f"{np.round(aucs[(score, precision)], 6).tolist()}")
                if score != "own":
                    knn_report[f"{model_type}/{score}/{precision}"] = {
                        "ms": secs * 1e3,
                        "mean_auc": float(aucs[(score, precision)].mean()),
                        "test_rows": int(data.test_x.shape[0]
                                         * data.test_x.shape[1])}
                if precision == "f32":
                    check_card_vs_cpu(torch, device, model, model_type,
                                      params, args, kw)
            if precision == "f32":
                results[model_type] = (model, params, data)
        for score in ("own", "knn/exact", "knn/approx"):
            delta = np.abs(aucs[(score, "bf16")]
                           - aucs[(score, "f32")]).max()
            log(f"[evaluate] {model_type} {score}: max |AUC bf16 - AUC f32|"
                f" = {delta:.3e}")
            if delta > 2e-3:
                raise AssertionError(f"{model_type} {score}: bf16 AUC off "
                                     f"f32 by {delta:.3e} > 2e-3")
    return results, knn_report


def check_card_vs_cpu(torch, device, model, model_type, params, args, kw):
    """The same evaluation on the CPU (the plain path) agrees on a small
    slice: 2 clients, 200 test rows each, their train rows."""
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    cpu = lambda t: t[:2, :200].cpu()  # noqa: E731
    small = [cpu(t) for t in args[:3]] + \
        [args[3][:2].cpu(), args[4][:2].cpu()]
    fn = make_evaluate_all(model, model_type, metric="scores", **kw)
    on_card = fn(params, *(t.to(device) for t in small)).cpu()
    on_cpu = fn({c: {n: {k: v.cpu() for k, v in layer.items()}
                     for n, layer in coder.items()}
                 for c, coder in params.items()}, *small)
    err = scaled_err(on_card, on_cpu)
    if err > TOL["f32"]:
        raise AssertionError(f"card vs CPU scores {kw}: {err:.3e}")


def phase_serve(torch, device, cfg, evaluated, smi):
    """10-gateway micro-batched serving, then 512 gateways with gather
    routing at 1024-row buckets; scores held to the evaluator's oracle."""
    from fedmse_tpu_torch.data import stack_clients, synthetic_clients
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.serving import (MicroBatcher, ServingEngine,
                                          fit_calibration, interleave_order)
    report = {}
    for model_type, (model, params, data) in evaluated.items():
        before = fused_forward_stats.launches
        oracle = make_evaluate_all(model, model_type, metric="scores")(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb).cpu().numpy()
        engine = ServingEngine.from_federation(
            model, model_type, params, data.train_xb, data.train_mb,
            max_bucket=cfg.serve_max_batch, device=device)
        calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                                data.valid_m.cpu().numpy())
        engine.warmup()
        test_x = data.test_x.cpu().numpy()
        gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
        rows = test_x[gws, ridx]
        batcher = MicroBatcher(engine, max_batch=cfg.serve_max_batch,
                               max_wait_ms=cfg.serve_latency_budget_ms,
                               calibration=calib)
        t0 = time.perf_counter()
        tickets = [batcher.submit(rows[i], int(gws[i]))
                   for i in range(len(rows))]
        batcher.drain()
        wall = time.perf_counter() - t0
        if len(tickets) < 8192 or not all(t.done for t in tickets):
            raise AssertionError("not every ticket was served")
        served = np.array([t.score for t in tickets], np.float32)
        want = oracle[gws, ridx]
        err = float(np.max(np.abs(served - want)
                           / np.maximum(1.0, np.abs(want))))
        if err > TOL["f32"]:
            raise AssertionError(f"{model_type} served scores off the "
                                 f"evaluator oracle by {err:.3e}")
        launched = fused_forward_stats.launches - before
        st = batcher.stats()
        report[f"serve10_{model_type}"] = {
            "rows": len(tickets), "rows_per_s": len(tickets) / wall,
            "latency_p50_ms": st["latency_p50_ms"],
            "latency_p99_ms": st["latency_p99_ms"],
            "dispatches": st["dispatches"], "launches": launched,
            "max_err_vs_oracle": err}
        log(f"[serve] {model_type} 10 gateways on {smi}: {len(tickets)} rows "
            f"in {st['dispatches']} buckets, {len(tickets) / wall:.1f} rows/s"
            f", latency p50 {st['latency_p50_ms']:.4f} ms p99 "
            f"{st['latency_p99_ms']:.4f} ms, {launched} launches, max err "
            f"vs oracle {err:.3e}")
        watched(f"rows/s, 10 gateways, {model_type}", len(tickets) / wall,
                1e5, True)
        watched(f"verdict p99 ms, 10 gateways, {model_type}",
                st["latency_p99_ms"], 4.0, False)

    clients = synthetic_clients(n_clients=512, dim=DIMS[0], n_normal=100,
                                n_abnormal=40, seed=SEED + 1)
    for model_type in ("autoencoder", "hybrid"):
        model = make_model(model_type, *DIMS,
                           shrink_lambda=cfg.shrink_lambda, device=device)
        params = init_stacked_params(
            model, 512, torch.Generator().manual_seed(SEED + 1),
            device=device)
        data = stack_clients(clients, np.zeros((1, DIMS[0]), np.float32),
                             cfg.batch_size, device=device)
        before = fused_forward_stats.launches
        oracle = make_evaluate_all(model, model_type, metric="scores")(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb).cpu().numpy()
        engine = ServingEngine.from_federation(
            model, model_type, params, data.train_xb, data.train_mb,
            max_bucket=1024, routing="gather", device=device)
        engine.warmup()
        test_x = data.test_x.cpu().numpy()
        gws, ridx = interleave_order(data.test_m.cpu().numpy(), 1 << 30)
        rows = test_x[gws, ridx]
        served = np.empty(len(rows), np.float32)
        bucket_s = []
        for s in range(0, len(rows), 1024):
            t0 = time.perf_counter()
            served[s:s + 1024] = engine.score(rows[s:s + 1024],
                                              gws[s:s + 1024])
            bucket_s.append(time.perf_counter() - t0)
        want = oracle[gws, ridx]
        err = float(np.max(np.abs(served - want)
                           / np.maximum(1.0, np.abs(want))))
        if err > TOL["f32"] or not np.isfinite(served).all():
            raise AssertionError(f"512-gateway {model_type} scores off the "
                                 f"oracle by {err:.3e}")
        launched = fused_forward_stats.launches - before
        ms = np.array(bucket_s) * 1e3
        report[f"serve512_{model_type}"] = {
            "rows": len(rows), "buckets": len(bucket_s),
            "rows_per_s": len(rows) / sum(bucket_s),
            "bucket_p50_ms": float(np.percentile(ms, 50)),
            "bucket_p99_ms": float(np.percentile(ms, 99)),
            "launches": launched, "max_err_vs_oracle": err}
        log(f"[serve] {model_type} 512 gateways gather on {smi}: "
            f"{len(rows)} rows in {len(bucket_s)} buckets of 1024, "
            f"{len(rows) / sum(bucket_s):.1f} rows/s, bucket p50 "
            f"{np.percentile(ms, 50):.4f} ms p99 {np.percentile(ms, 99):.4f}"
            f" ms, {launched} launches, max err vs oracle {err:.3e}")
        watched(f"rows/s, 512 gateways, {model_type}", len(rows)
                / sum(bucket_s), 1e6, True)
    return report


def phase_serve_knn(torch, device, cfg, evaluated, smi):
    """kNN serving (512-slot banks, k = 8, approximate top-k): the hybrid
    10-gateway federation through MicroBatcher and through
    ContinuousBatcher with a build_banks(existing=...) swap in the middle
    of the stream, then 512 gateways with gather routing at 1024-row
    buckets; scores held to the evaluator's oracle (after the swap: to the
    plain CPU path on the refreshed bank)."""
    from fedmse_tpu_torch.data import stack_clients, synthetic_clients
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.knn import (build_banks, dist_tiles,
                                      routed_kth_distance)
    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.serving import (ContinuousBatcher, MicroBatcher,
                                          ServingEngine, fit_calibration,
                                          interleave_order)
    kw = dict(score_kind="knn", knn_topk=cfg.knn_topk, **KNN)
    report = {}
    model, params, data = evaluated["hybrid"]
    oracle = make_evaluate_all(model, "hybrid", metric="scores", **kw)(
        params, data.test_x, data.test_m, data.test_y, data.train_xb,
        data.train_mb).cpu().numpy()
    engine = ServingEngine.from_federation(
        model, "hybrid", params, data.train_xb, data.train_mb,
        max_bucket=cfg.serve_max_batch, device=device, **kw)
    calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                            data.valid_m.cpu().numpy())
    engine.warmup()
    test_x = data.test_x.cpu().numpy()
    gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
    rows, want = test_x[gws, ridx], oracle[gws, ridx]

    def held(served, ref, what):
        err = float(np.max(np.abs(served - ref)
                           / np.maximum(1.0, np.abs(ref))))
        if err > TOL["f32"] or not np.isfinite(served).all():
            raise AssertionError(f"{what} off its oracle by {err:.3e}")
        return err

    before = dist_tiles.launches
    batcher = MicroBatcher(engine, max_batch=cfg.serve_max_batch,
                           max_wait_ms=cfg.serve_latency_budget_ms,
                           calibration=calib)
    t0 = time.perf_counter()
    tickets = [batcher.submit(rows[i], int(gws[i])) for i in range(len(rows))]
    batcher.drain()
    wall = time.perf_counter() - t0
    err = held(np.array([t.score for t in tickets], np.float32), want,
               "knn micro-batched scores")
    st = batcher.stats()
    report["serve10_knn_sync"] = {
        "rows": len(tickets), "rows_per_s": len(tickets) / wall,
        "latency_p50_ms": st["latency_p50_ms"],
        "latency_p99_ms": st["latency_p99_ms"],
        "dispatches": st["dispatches"],
        "dist_launches": dist_tiles.launches - before,
        "max_err_vs_oracle": err}
    log(f"[serve] knn 10 gateways sync on {smi}: {len(tickets)} rows in "
        f"{st['dispatches']} buckets, {len(tickets) / wall:.1f} rows/s, "
        f"latency p50 {st['latency_p50_ms']:.4f} ms p99 "
        f"{st['latency_p99_ms']:.4f} ms, max err vs oracle {err:.3e}")
    watched("rows/s, 10 gateways, knn", len(tickets) / wall, 1e5, True)
    watched("verdict p99 ms, 10 gateways, knn", st["latency_p99_ms"], 4.0,
            False)

    # continuous front, the refreshed bank swapped in mid-stream
    refreshed = build_banks(model, params, data.valid_x, data.valid_m,
                            existing=engine.banks, seed=SEED + 7)
    front = ContinuousBatcher(engine, max_batch=cfg.serve_max_batch,
                              latency_budget_ms=cfg.serve_latency_budget_ms,
                              calibration=calib)
    half = len(rows) // 2
    t0 = time.perf_counter()
    tickets = [front.submit(rows[i], int(gws[i])) for i in range(half)]
    old_rows = front.rows_submitted - front.forming_rows
    event = front.swap(banks=refreshed)
    tickets += [front.submit(rows[i], int(gws[i]))
                for i in range(half, len(rows))]
    front.drain()
    wall = time.perf_counter() - t0
    st = front.stats()
    if not (st["rows_served"] == st["rows_submitted"] == len(rows)
            and sum(front.dispatch_batch_sizes) == len(rows)
            and all(t.done for t in tickets)):
        raise AssertionError(f"continuous front dropped or re-scored rows: "
                             f"{st['rows_served']} of {len(rows)}")
    served = np.array([t.score for t in tickets], np.float32)
    err_old = held(served[:old_rows], want[:old_rows],
                   "pre-swap continuous scores")
    installed = engine.banks
    if not (torch.equal(installed.latents.cpu(), refreshed.latents.cpu())
            and torch.equal(installed.count.cpu(), refreshed.count.cpu())):
        raise AssertionError("the swap did not install the refreshed bank")
    # the rows after the swap, scored independently: the plain forward and
    # plain distances on the CPU against a CPU copy of the refreshed bank
    cdt = engine.policy.compute_dtype
    gw_cpu = torch.from_numpy(gws[old_rows:].astype(np.int32))
    latent, _, _ = fused_forward_stats(
        {c: {n: {k: v.cpu() for k, v in layer.items()}
             for n, layer in coder.items()}
         for c, coder in engine.params.items()},
        torch.from_numpy(rows[old_rows:]).to(cdt), gw_cpu,
        compute_dtype=cdt)
    ref_new = torch.nan_to_num(routed_kth_distance(
        latent, gw_cpu, refreshed.to("cpu"), engine.knn_k,
        topk=engine.knn_topk)).numpy()
    err_new = held(served[old_rows:], ref_new, "post-swap continuous scores")
    report["serve10_knn_continuous"] = {
        "rows": len(rows), "rows_per_s": len(rows) / wall,
        "latency_p50_ms": st["latency_p50_ms"],
        "latency_p99_ms": st["latency_p99_ms"],
        "dispatches": st["dispatches"], "swap": event,
        "rows_before_swap": int(old_rows),
        "max_err_vs_oracle": max(err_old, err_new)}
    log(f"[serve] knn 10 gateways continuous on {smi}: {len(rows)} rows in "
        f"{st['dispatches']} buckets, {len(rows) / wall:.1f} rows/s, p99 "
        f"{st['latency_p99_ms']:.4f} ms, bank swap after {old_rows} rows "
        f"({event['kinds']}), rows_served == rows_submitted == "
        f"{st['rows_served']}, max err {max(err_old, err_new):.3e}")
    watched("verdict p99 ms, 10 gateways, knn, continuous front",
            st["latency_p99_ms"], 4.0, False)

    clients = synthetic_clients(n_clients=512, dim=DIMS[0], n_normal=100,
                                n_abnormal=40, seed=SEED + 1)
    model = make_model("autoencoder", *DIMS, shrink_lambda=cfg.shrink_lambda,
                       device=device)
    params = init_stacked_params(model, 512,
                                 torch.Generator().manual_seed(SEED + 1),
                                 device=device)
    data = stack_clients(clients, np.zeros((1, DIMS[0]), np.float32),
                         cfg.batch_size, device=device)
    oracle = make_evaluate_all(model, "autoencoder", metric="scores", **kw)(
        params, data.test_x, data.test_m, data.test_y, data.train_xb,
        data.train_mb).cpu().numpy()
    engine = ServingEngine.from_federation(
        model, "autoencoder", params, data.train_xb, data.train_mb,
        max_bucket=1024, routing="gather", device=device, **kw)
    engine.warmup()
    test_x = data.test_x.cpu().numpy()
    gws, ridx = interleave_order(data.test_m.cpu().numpy(), 1 << 30)
    rows = test_x[gws, ridx]
    served = np.empty(len(rows), np.float32)
    bucket_s = []
    before = dist_tiles.launches
    for s0 in range(0, len(rows), 1024):
        t0 = time.perf_counter()
        served[s0:s0 + 1024] = engine.score(rows[s0:s0 + 1024],
                                            gws[s0:s0 + 1024])
        bucket_s.append(time.perf_counter() - t0)
    err = held(served, oracle[gws, ridx], "512-gateway knn scores")
    ms = np.array(bucket_s) * 1e3
    report["serve512_knn"] = {
        "rows": len(rows), "buckets": len(bucket_s),
        "rows_per_s": len(rows) / sum(bucket_s),
        "bucket_p50_ms": float(np.percentile(ms, 50)),
        "bucket_p99_ms": float(np.percentile(ms, 99)),
        "dist_launches": dist_tiles.launches - before,
        "max_err_vs_oracle": err}
    log(f"[serve] knn 512 gateways gather on {smi}: {len(rows)} rows in "
        f"{len(bucket_s)} buckets of 1024, {len(rows) / sum(bucket_s):.1f} "
        f"rows/s, bucket p50 {np.percentile(ms, 50):.4f} ms p99 "
        f"{np.percentile(ms, 99):.4f} ms, max err vs oracle {err:.3e}")
    return report


def phase_train(torch, device, cfg, clients):
    """The training path at the paper's width through the driver's default,
    the fused, pipelined schedule (federation/fused.py, pipeline.py):
    every combination in f32, hybrid / mse_avg in bf16. Per round: the
    aggregator (or why there is none), mean AUC and wall time (the
    chunk's wall over its rounds: with the three quick-run rounds in one
    chunk, each carries a third of the graphs' capture, so the steady
    round is watched in phase_fused_hold and profile_round); per
    combination each kernel's launches
    (graph replays times the kernels each graph holds, and the eager
    warm-ups). The f32 hybrid / mse_avg run writes its checkpoint for
    phase_serve_trained."""
    from fedmse_tpu_torch.checkpointing import ResultsWriter
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.ops.fused_train import fused_train_grads
    from fedmse_tpu_torch.ops.precision import get_policy
    if not (cfg.fused_rounds and cfg.fused_schedule and cfg.fused_pipeline):
        raise AssertionError("the driver's default is not the fused, "
                             "pipelined schedule")
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    names = [c.name for c in clients]
    ckpt = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    writer = ResultsWriter(ckpt, cfg.network_size, "chip-smoke",
                           cfg.scen_name, cfg.metric, cfg.num_participants)
    datas, report, outs = {}, {}, {}
    runs = [(mt, ut, "f32") for mt in ("hybrid", "autoencoder")
            for ut in ("avg", "fedprox", "mse_avg")]
    runs.append(("hybrid", "mse_avg", "bf16"))
    for model_type, update_type, precision in runs:
        c = cfg.replace(precision=precision)
        if precision not in datas:
            datas[precision] = stack_clients(
                clients, dev_x, c.batch_size,
                dtype=get_policy(precision).compute_dtype, device=device)
        tag = f"{model_type}/{update_type}/{precision}"
        last = [fused_train_grads.launches, fused_forward_stats.launches]
        counts = np.zeros(len(clients), np.int64)  # aggregations so far
        rows = []

        def on_round(result, sec, tag=tag, counts=counts, rows=rows,
                     thr=c.max_aggregation_threshold):
            auc = result.client_metrics
            if not np.isfinite(auc).all():
                raise AssertionError(f"{tag}: AUC not finite: {auc}")
            why = ""
            if result.aggregator is None:
                sel = result.selected
                if len(sel) > 1 and any(counts[i] < thr for i in sel):
                    raise AssertionError(f"{tag}: no aggregator though a "
                                         "cohort client is under the quota")
                why = (" (none: a cohort of one)" if len(sel) < 2 else
                       " (none: every cohort client is over the quota)")
            else:
                counts[result.aggregator] += 1
            rows.append({"round": result.round_index + 1,
                         "aggregator": result.aggregator,
                         "mean_auc": float(np.mean(auc)), "seconds": sec})
            log(f"[train] {tag} round {result.round_index + 1}: aggregator "
                f"{result.aggregator}{why}, mean AUC {np.mean(auc):.6f}, "
                f"{sec:.4f} s")

        serve = (model_type, update_type, precision) == \
            ("hybrid", "mse_avg", "f32")
        t0 = time.perf_counter()
        out = run_combination(c, datas[precision], len(clients), model_type,
                              update_type, 0, writer=writer,
                              device_names=names, save_checkpoints=serve,
                              on_round=on_round)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = [fused_train_grads.launches - last[0],
                    fused_forward_stats.launches - last[1]]
        outs[tag] = out
        fused = out["engine"].fused_round().stats()
        report[tag] = {"rounds": rows,
                       "final_mean_auc": float(np.mean(out["final_metrics"])),
                       "seconds": seconds, "train_launches": launched[0],
                       "forward_launches": launched[1], "fused": fused}
        log(f"[train] {tag}: final mean AUC "
            f"{report[tag]['final_mean_auc']:.6f} in {seconds:.2f} s; "
            f"fused_ae_train x{launched[0]}, fused_ae_forward "
            f"x{launched[1]}; epochs {fused['epochs_run']}, "
            f"{fused['host_reads']} host reads; graphs "
            f"{json.dumps(fused['graphs'])}")
    delta = abs(report["hybrid/mse_avg/bf16"]["final_mean_auc"]
                - report["hybrid/mse_avg/f32"]["final_mean_auc"])
    log(f"[train] hybrid/mse_avg: |final mean AUC bf16 - f32| = {delta:.3e} "
        f"(the pin is phase_train_orders')")
    return report, outs["hybrid/mse_avg/f32"], datas, writer, names


def _nan_scaled_err(torch, got, want) -> float:
    """scaled_err over two arrays whose NaNs (an unselected client's
    min_valid and curve) must sit at the same places."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    return scaled_err(torch.nan_to_num(got), torch.nan_to_num(want))


def _state_errs(torch, layout, got, want) -> dict:
    """Per-leaf scale-normalized errors of two ClientStates: params,
    prev_global and hist_params by leaf, the Adam state and the verifier's
    vectors."""
    errs = {}
    for name in ("params", "prev_global", "hist_params"):
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        errs[name] = max(scaled_err(a[:, sl], b[:, sl])
                         for sl in layout.slices())
    for name, a, b in zip(("count", "mu", "nu"), got.opt_state,
                          want.opt_state):
        errs[f"opt_{name}"] = max(
            scaled_err(a.cpu()[:, sl] if a.dim() == 2 else a.cpu(),
                       b.cpu()[:, sl] if b.dim() == 2 else b.cpu())
            for sl in layout.slices())
    for name in ("hist_perf", "hist_seen", "rejected", "waived"):
        errs[name] = scaled_err(getattr(got, name).cpu().double(),
                                getattr(want, name).cpu().double())
    return errs


def _same_bits(torch, a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(torch.equal(
        torch.nan_to_num(a.double(), nan=1e300),
        torch.nan_to_num(b.double(), nan=1e300)))


def phase_fused_hold(torch, device, cfg, clients):
    """The fused round (CUDA graphs) held to the per-phase round at the
    paper's width: 10 gateways, a 5-client cohort, the quick run's 5
    epochs, the same init, cohort and data, the vote tie-break off.
    hybrid / mse_avg and autoencoder / fedprox in f32, hybrid / mse_avg in
    bf16, and one kNN-scored hybrid / mse_avg round. After one round the
    states (every leaf, the Adam state, the verifier's history) and the
    RoundResult fields must agree within 1e-6 scale-normalized (the same
    kernels in the same order: bit-equal expected), with the same
    aggregator and verification rows; a second fused round from the same
    state replays the captured graphs and must give the first's bits."""
    import dataclasses
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.federation import (HostState, RoundEngine,
                                             init_client_states)
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.precision import get_policy
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    base = cfg.replace(compat=dataclasses.replace(cfg.compat,
                                                  vote_tie_break=False))
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    layout, n = ParamLayout(*DIMS), len(clients)
    datas, report, worst = {}, {}, 0.0
    cases = [("hybrid", "mse_avg", "f32", "auto"),
             ("autoencoder", "fedprox", "f32", "auto"),
             ("hybrid", "mse_avg", "bf16", "auto"),
             ("hybrid", "mse_avg", "f32", "knn")]
    for model_type, update_type, precision, kind in cases:
        c = base.replace(precision=precision, score_kind=kind,
                         **(KNN if kind == "knn" else {}))
        if precision not in datas:
            datas[precision] = stack_clients(
                clients, dev_x, c.batch_size,
                dtype=get_policy(precision).compute_dtype, device=device)
        model = make_model(model_type, *DIMS, c.shrink_lambda,
                           precision=precision, device=device)
        init = init_client_states(model, n, torch.Generator().manual_seed(
            SEED + 5), device=device)

        def engine(fused):
            return RoundEngine(model, c, datas[precision], n_real=n,
                               rngs=ExperimentRngs(run=0),
                               model_type=model_type,
                               update_type=update_type, states=init,
                               fused=fused)
        per, fus = engine(False), engine(True)
        selected = per.select_clients()
        t0 = time.perf_counter()
        want = per.run_round(0, selected=selected)
        torch.cuda.synchronize()
        per_s = time.perf_counter() - t0
        got, seconds, states = [], [], []
        for _ in range(2):  # capture, then a replay from the same state
            fus.states, fus.host = init, HostState.create(n)
            t0 = time.perf_counter()
            got.append(fus.run_round(0, selected=selected))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            states.append(fus.states.clone())
        tag = f"{model_type}/{update_type}/{precision}/{kind}"
        for g in got:
            if (g.aggregator != want.aggregator
                    or g.verification_results != want.verification_results):
                raise AssertionError(f"[fused-hold] {tag}: aggregator "
                                     f"{g.aggregator} vs {want.aggregator}"
                                     " or verification rows differ")
        errs = _state_errs(torch, layout, states[0], per.states)
        for field in ("client_metrics", "mse_scores", "agg_weights",
                      "min_valid", "tracking"):
            errs[field] = _nan_scaled_err(torch, getattr(got[0], field),
                                          getattr(want, field))
        replay_bits = all(
            _same_bits(torch, getattr(got[1], f), getattr(got[0], f))
            for f in ("client_metrics", "mse_scores", "agg_weights",
                      "min_valid", "tracking")) and max(
            _state_errs(torch, layout, states[1], states[0]).values()) == 0
        err = max(errs.values())
        worst = max(worst, err)
        bitwise = err == 0.0
        stats = fus.fused_round().stats()
        report[tag] = {"max_scaled_err": err, "errs": errs,
                       "bit_equal": bitwise, "replay_bit_equal": replay_bits,
                       "aggregator": want.aggregator,
                       "per_phase_round_s": per_s,
                       "fused_round_s": seconds, "fused": stats}
        watched(f"fused round seconds (graphs replayed), {tag}",
                seconds[1], 0.5, False)
        log(f"[fused-hold] {tag}: aggregator {want.aggregator}, fused vs "
            f"per-phase max scaled error {err:.3e} (bit-equal: {bitwise}); "
            f"replay bit-equal: {replay_bits}; per-phase {per_s:.3f} s, "
            f"fused {seconds[0]:.3f} s (capture) / {seconds[1]:.3f} s; "
            f"graphs {json.dumps(stats['graphs'])}")
        if not err <= 1e-6 or not replay_bits:
            raise AssertionError(f"[fused-hold] {tag}: fused vs per-phase "
                                 f"{json.dumps(errs)}, replay bit-equal "
                                 f"{replay_bits}")
    log(f"[fused-hold] worst scaled error over {len(cases)} cases: "
        f"{worst:.3e} (limit 1e-6)")
    return {"cases": report, "worst_scaled_err": worst}


def phase_train_orders(torch, cfg, datas, n_clients, report):
    """hybrid / mse_avg trained again in f32 and in bf16 with the train
    kernel at 4, 2 and 1 CTAs per client: the same function in three more
    summation orders beside the main path's 8. The quick run's final AUC is
    chaotic (Adam on the loss plateau, early stops that flip; ROADMAP queue
    3): over these four orders the f32 final mean AUC spanned 0.99487 to
    0.99999 on an H100 (PERF.md), more than the pin. So bf16 is held to
    f32 on the mean over the four orders of each one's final mean AUC,
    within 2e-3."""
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.ops import fused_train
    finals = {p: [report[f"hybrid/mse_avg/{p}"]["final_mean_auc"]]
              for p in ("f32", "bf16")}
    sizes = [8]
    pick = fused_train.cluster_size
    try:
        for size in (4, 2, 1):
            fused_train.cluster_size = \
                lambda g, h, size=size: min(size, h, pick(g, h))
            sizes.append(size)
            for precision in finals:
                out = run_combination(cfg.replace(precision=precision),
                                      datas[precision], n_clients, "hybrid",
                                      "mse_avg", 0)
                finals[precision].append(
                    float(np.mean(out["final_metrics"])))
    finally:
        fused_train.cluster_size = pick
    torch.cuda.synchronize()
    means = {p: float(np.mean(v)) for p, v in finals.items()}
    delta = abs(means["bf16"] - means["f32"])
    log(f"[train] hybrid/mse_avg final mean AUC at {sizes} CTAs per client: "
        f"{json.dumps(finals)}; |mean bf16 - mean f32| = {delta:.3e}")
    if delta > 2e-3:
        raise AssertionError(f"bf16 training's AUC off f32 by {delta:.3e}")
    return {"cluster_sizes": sizes, "final_mean_auc": finals,
            "mean_abs_delta": delta}


def phase_serve_trained(torch, device, cfg, out, data, writer, names):
    """The trained hybrid federation's checkpoint, served: scores equal to
    the evaluator's oracle on the trained params."""
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.serving import ServingEngine, interleave_order
    engine = out["engine"]
    oracle = make_evaluate_all(engine.model, "hybrid", metric="scores")(
        engine.model_params(), data.test_x, data.test_m, data.test_y,
        data.train_xb, data.train_mb).cpu().numpy()
    served_engine = ServingEngine.from_checkpoint(
        writer, engine.model, "hybrid", "mse_avg", names, run=0,
        train_x=data.train_xb, train_m=data.train_mb,
        max_bucket=cfg.serve_max_batch, device=device)
    gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
    test_x = data.test_x.cpu().numpy()
    served = np.concatenate([
        served_engine.score(test_x[gws[s:s + 256], ridx[s:s + 256]],
                            gws[s:s + 256])
        for s in range(0, len(gws), 256)])
    want = oracle[gws, ridx]
    err = float(np.max(np.abs(served - want) / np.maximum(1.0, np.abs(want))))
    if err > TOL["f32"] or not np.isfinite(served).all():
        raise AssertionError(f"served trained checkpoint off the oracle by "
                             f"{err:.3e}")
    log(f"[train] trained hybrid/mse_avg checkpoint served: {len(served)} "
        f"rows, max error vs the evaluator oracle {err:.3e}")
    return err


def forced_gc_ms() -> dict:
    """Milliseconds of one forced full collection in this process as it
    stands (after training): without a freeze, under gc.freeze() (what
    run_serve_smoke does for its stream) and without one again."""
    def timed():
        t0 = time.perf_counter()
        gc.collect()
        return (time.perf_counter() - t0) * 1e3
    gc.collect()  # the garbage that training left
    out = {"tracked_objects": len(gc.get_objects()), "unfrozen": timed()}
    gc.freeze()
    try:
        out["frozen"] = timed()
    finally:
        gc.unfreeze()
    out["unfrozen_again"] = timed()
    return out


def phase_serve_pass(torch, cfg, data, writer, names):
    """The CLI's --serve pass (serving.run_serve_smoke) on the trained
    hybrid / mse_avg checkpoint, with the kNN score and the continuous
    front, cold (the CLI's default) three times and then with
    --serve-warmup: the bank npz and the calibration JSON must be written.
    First, one forced full collection timed with and without the freeze
    the pass puts around its stream; each pass records every GC pause."""
    from fedmse_tpu_torch.knn import dist_tiles, load_bank
    from fedmse_tpu_torch.serving import run_serve_smoke
    c = cfg.replace(score_kind="knn", **KNN)
    gc_ms = forced_gc_ms()
    log(f"[serve-pass] one forced full collection after training: "
        f"{json.dumps(gc_ms)} ms ({gc_ms['tracked_objects']} objects "
        f"tracked)")
    watched("forced full collection under gc.freeze / without, ratio",
            gc_ms["frozen"] / max(gc_ms["unfrozen"], 1e-9), 0.5, False)
    out = {"forced_gc_ms": gc_ms, "cold_passes": []}
    for tag in ("cold", "cold", "cold", "warm"):
        warmup = tag == "warm"
        before = dist_tiles.launches
        pauses = []  # the garbage collector's pauses during the pass

        def on_gc(phase, info, pauses=pauses, t=[0.0]):
            if phase == "start":
                t[0] = time.perf_counter()
            else:
                pauses.append((info["generation"],
                               (time.perf_counter() - t[0]) * 1e3))
        gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        rep = run_serve_smoke(c, data, len(names), writer, names, "hybrid",
                              "mse_avg", run=0, max_rows=8192,
                              max_batch=c.serve_max_batch,
                              max_wait_ms=c.serve_latency_budget_ms,
                              warmup=warmup, continuous=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
        if gc.get_freeze_count() != 0:
            raise AssertionError("the --serve pass left the collector "
                                 "frozen")
        bank = load_bank(rep["knn_bank_path"], device=data.train_xb.device)
        if not (rep["score_kind"] == "knn" and rep["front"] == "continuous"
                and os.path.exists(rep["calibration_path"])
                and bank.num_gateways == len(names)
                and bank.bank_size == c.knn_bank_size
                and rep["batcher"]["rows_served"] == rep["rows"] > 0
                and rep["verdict_label_agreement"] is not None):
            raise AssertionError(f"--serve pass report: "
                                 f"{json.dumps(rep)[:800]}")
        entry = {
            "rows": rep["rows"], "seconds": secs,
            "rows_per_sec_wall": rep["batcher"]["rows_per_sec_wall"],
            "latency_p50_ms": rep["batcher"]["latency_p50_ms"],
            "latency_p99_ms": rep["batcher"]["latency_p99_ms"],
            "mean_batch": rep["batcher"]["mean_batch"],
            "verdict_label_agreement": rep["verdict_label_agreement"],
            "drifted_gateways": rep["drift"]["drifted_gateways"],
            "dist_launches": dist_tiles.launches - before,
            "latency_max_ms_by_eighth": rep["latency_max_ms_by_eighth"],
            "warmup_sec_per_bucket": rep["warmup_sec_per_bucket"],
            "gc_pauses": len(pauses),
            "gc_max_pause_ms": max((ms for _, ms in pauses), default=0.0),
            "gc_full_collections": sum(g == 2 for g, _ in pauses)}
        if warmup:
            out["warm"] = entry
        else:
            out["cold_passes"].append(entry)
            tag = f"cold {len(out['cold_passes'])}"
        log(f"[serve-pass] --serve ({tag}) on the trained hybrid/mse_avg "
            f"checkpoint, knn, continuous front: {json.dumps(entry)}; "
            f"bank {os.path.basename(rep['knn_bank_path'])} and calibration"
            f" written")
        watched(f"verdict p99 ms, --serve pass ({tag})",
                entry["latency_p99_ms"], 4.0, False)
    return out


def baseline_dist(torch):
    """fn(q, banks, gw) -> [T, B] launching the distance kernel's
    predecessor (csrc/dist_tiles_baseline.cu, f32 queries) on the current
    stream: the yardstick the redesign is timed against."""
    import ctypes
    from fedmse_tpu_torch.ops import native
    lib = native.load("dist_tiles_baseline")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dist_tiles.argtypes = [ptr] * 4 + [ctypes.c_longlong] + [i32] * 3 \
        + [ptr]
    lib.dist_tiles.restype = i32

    def call(q, banks, gw):
        out = torch.empty((q.shape[0], banks.shape[1]), device=q.device)
        rc = lib.dist_tiles(q.data_ptr(), banks.data_ptr(),
                            None if gw is None else gw.data_ptr(),
                            out.data_ptr(), q.shape[0], banks.shape[0],
                            banks.shape[1], q.shape[1],
                            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the baseline distance launch failed ({rc})")
        return out
    return call


def report_dist(torch, device, launches, worst, eval_rows):
    """The distance kernel's, its predecessor's (csrc/dist_tiles_baseline.cu,
    whose bits it must reproduce), its plain version's and torch.cdist's
    times and the bound at the main path's shapes: the 10-gateway
    evaluation (its `eval_rows` test rows client-major against 512-slot
    banks) and the two serving buckets. At each shape also the kNN score
    around the kernel (routed_kth_distance with exact and approximate
    top-k: the launch, the padding mask, the top-k and the gather) on the
    device, the kernel's share of it, and a one-element fill as the floor
    of any launch. Each timed call's output is first held to the plain
    version on the same inputs."""
    from fedmse_tpu_torch.knn.bank import ReferenceBank
    from fedmse_tpu_torch.knn.score import (dist_tiles, dist_tiles_plain,
                                            routed_kth_distance)
    gen = torch.Generator().manual_seed(SEED + 8)
    bank = KNN["knn_bank_size"]
    parent = baseline_dist(torch)
    one = torch.zeros(1, device=device)
    fill_ms = all_device_ms(torch, lambda: one.fill_(1.0), 50)
    floor_ms = {key: graph_ms(torch, lambda: one.fill_(1.0), device, 200,
                              calls)
                for key, calls in (("graph_ms", 1),
                                   ("graph_ms_calls", GRAPH_CALLS))}
    log(f"[report] one-element fill on the device {fill_ms:.5f} ms "
        f"(torch.profiler), its one-call graph replay "
        f"{floor_ms['graph_ms']:.5f} ms, per call in a graph of "
        f"{GRAPH_CALLS} {floor_ms['graph_ms_calls']:.5f} ms (the floor of "
        f"any launch)")
    rows_out = []
    for what, n, rows, gw_kind in main_dist_shapes(eval_rows):
        q, banks, gw = dist_inputs(torch, n, rows, bank, DIMS[2], gw_kind,
                                   gen, device, torch.float32)
        got, _, err = dist_check(torch, q, banks, gw, f"timed {what}")
        if not torch.equal(parent(q, banks, gw).view(torch.int32),
                           got.view(torch.int32)):
            raise AssertionError(f"dist {what}: the kernel's bits differ "
                                 "from its predecessor's")
        call = lambda: dist_tiles(q, banks, gw)  # noqa: E731
        k_ms = cuda_ms(call, 200)
        used = n if gw is None else int(torch.unique(gw).numel())
        b_ms, b_by = dist_bound(rows, bank, used)
        g_ms = graph_time(torch, call, device, 200, b_ms)
        d_ms = device_ms(call, "dist_tiles", 50)
        parent_ms = device_ms(lambda: parent(q, banks, gw), "dist_tiles", 50)
        d2_ms = device_ms(call, "dist_tiles", 50)
        p_ms = cuda_ms(lambda: dist_tiles_plain(q, banks, gw), 10)
        lib_ms = None
        if gw_kind == "client_major":
            # one library call on the batched [N, T/N, L] x [N, B, L] shape;
            # it computes the square root of the same function
            qb = q.view(n, rows // n, DIMS[2])
            lib_ms = cuda_ms(lambda: torch.cdist(
                qb, banks, compute_mode="use_mm_for_euclid_dist"), 50)
        count = torch.randint(bank // 2, bank + 1, (n,), generator=gen,
                              dtype=torch.int32).to(device)
        ref = ReferenceBank(latents=banks, count=count)
        g = gw if gw is not None else torch.zeros(rows, dtype=torch.int32,
                                                  device=device)
        path_ms = {topk: all_device_ms(torch, lambda topk=topk:
                                       routed_kth_distance(
                                           q, g, ref, KNN["knn_k"],
                                           topk=topk), 20)
                   for topk in ("exact", "approx")}
        rows_out.append({
            "what": what, "rows": rows, "banks": n, "bank_size": bank,
            "ms": k_ms, **g_ms, "graph_floor_ms": floor_ms,
            "device_ms": d_ms, "device_ms_again": d2_ms,
            "parent_device_ms": parent_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "knn_path_device_ms": path_ms,
            "kernel_share_of_knn_path": {
                k: d_ms / v for k, v in path_ms.items()},
            "fill_device_ms": fill_ms,
            "scaled_err_vs_plain": err})
        log(f"[report] dist {what} T={rows} B={bank} N={n}: wrapper call "
            f"{k_ms:.5f} ms, one-call graph replay {_graph_text(g_ms)} "
            f"(a fill's {json.dumps(floor_ms)}), kernel on the device "
            f"(torch.profiler, a cross-check) {d_ms:.5f} / {d2_ms:.5f} "
            f"ms against its predecessor's {parent_ms:.5f} (same bits), "
            f"plain {p_ms:.5f} ms, torch.cdist {lib_ms} ms, bound "
            f"{b_ms:.6f} ms ({b_by}); kNN score on the device "
            f"{path_ms['exact']:.5f} (exact) / {path_ms['approx']:.5f} "
            f"(approx) ms, the kernel {d_ms / path_ms['exact']:.1%} / "
            f"{d_ms / path_ms['approx']:.1%} of it; scaled error vs plain "
            f"{err:.3e}")
    main = rows_out[0]
    return {
        "name": "dist_tiles",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/dist_tiles.cu",
        "replaces": "fedmse_tpu/knn/score.py:51 (_dist_kernel)",
        "launches": launches,
        "max_abs_err": worst["f32"]["abs"],
        "ms": main["ms"], "graph_ms": main["graph_ms"],
        "graph_ms_below_bound": main.get("graph_ms_below_bound"),
        "graph_ms_calls": main["graph_ms_calls"],
        "graph_ms_calls_below_bound": main.get(
            "graph_ms_calls_below_bound"), "graph_calls": GRAPH_CALLS,
        "graph_floor_ms": floor_ms, "device_ms": main["device_ms"],
        "parent_device_ms": main["parent_device_ms"],
        "parent_source": "fedmse_tpu_torch/csrc/dist_tiles_baseline.cu",
        "knn_path_ms": main["knn_path_device_ms"]["exact"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": "torch.cdist(q [N, T/N, L], banks [N, B, L], "
                        "compute_mode='use_mm_for_euclid_dist')",
        "fill_device_ms": fill_ms,
        "max_abs_err_by_dtype": {p: worst[p]["abs"] for p in worst},
        "max_scaled_err_by_dtype": {p: worst[p]["scaled"] for p in worst},
        "tolerance_scaled": DIST_TOL,
        "shapes": rows_out,
    }


def _profile_path(torch, engine, path, states, host, k, selected):
    """One round on `path` from (states, host), twice: timed on the host
    clock, then under torch.profiler for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from fedmse_tpu_torch.ops.fused_train import fused_train_grads
    fused = engine.fused_round()
    engine.profile = path == "per_phase"  # profile forces per-phase
    engine.states, engine.host = states, host.copy()
    bodies = (fused.enter, fused.epoch, fused.leave)
    reads = fused.host_reads
    replays = sum(b.replays for b in bodies)
    epoch_s = (fused.epoch.replays, fused.epoch.replay_seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_round(k, selected=selected)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    reads = fused.host_reads - reads
    replays = sum(b.replays for b in bodies) - replays
    # the host's milliseconds in one replay() of the epoch graph
    epoch_replay_ms = ((fused.epoch.replay_seconds - epoch_s[1]) * 1e3
                       / max(fused.epoch.replays - epoch_s[0], 1))
    engine.states, engine.host = states, host.copy()
    before = fused_train_grads.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run_round(k, selected=selected)
        torch.cuda.synchronize()
    steps = fused_train_grads.launches - before
    engine.profile = False
    by_name, calls = {}, {}
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            calls[e.key] = calls.get(e.key, 0) + e.count
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    r = {"wall_ms": wall_ms, "device_busy_ms": busy,
         "device_busy_share": busy / wall_ms, "train_steps": steps,
         "host_ms_per_step": wall_ms / max(steps, 1),
         "device_ms_per_step": busy / max(steps, 1),
         "device_ops_per_step": sum(calls.values()) / max(steps, 1),
         # kernel name (cut to 80 characters): [device ms, launches]
         "top_kernels": {n[:80]: [v, calls[n]] for n, v in top}}
    if path != "per_phase":
        r.update({"host_reads": reads, "graph_replays": replays,
                  "epoch_replay_host_ms": epoch_replay_ms,
                  "epochs_run": fused.epochs_run[-1],
                  "graphs": fused.stats()["graphs"]})
    return r, {n[:60]: [round(v, 3), calls[n]] for n, v in top}


def profile_round(torch, out):
    """One more round of the trained hybrid / mse_avg federation on each
    path, the fused round (CUDA graphs) and the per-phase round, each
    twice from the same state and cohort: timed on the host clock, then
    under torch.profiler (whose per-launch cost inflates the wall clock)
    for the device time by kernel. Busy share = device time / unprofiled
    wall. For the fused round also the host's reads (one early-stop flag
    per epoch but the first), the graph replays, the host's time per
    epoch replay, the epochs run and the capture seconds and nodes of its
    graphs (captured in phase_train)."""
    engine = out["engine"]
    states, host = engine.states.clone(), engine.host.copy()
    selected = engine.select_clients()
    results = {}
    for path in ("fused", "per_phase"):
        r, tops = _profile_path(torch, engine, path, states, host,
                                engine.cfg.num_rounds, selected)
        results[path] = r
        log(f"[profile] one hybrid/mse_avg round, {path}: wall "
            f"{r['wall_ms']:.2f} ms, {r['train_steps']} train steps "
            f"({r['host_ms_per_step']:.4f} ms of wall and "
            f"{r['device_ms_per_step']:.4f} ms of device time each, "
            f"{r['device_ops_per_step']:.2f} device ops), device busy "
            f"{r['device_busy_ms']:.2f} ms "
            f"({100 * r['device_busy_share']:.1f}%)"
            + (f", {r['epochs_run']} epochs, {r['host_reads']} host "
               f"reads, {r['graph_replays']} graph replays "
               f"({r['epoch_replay_host_ms']:.3f} ms of host time per "
               f"epoch replay)" if path == "fused" else "")
            + f"; top kernels {json.dumps(tops)}")
    engine.states, engine.host = states, host
    watched("fused round wall seconds, profiled round",
            results["fused"]["wall_ms"] / 1e3, 0.5, False)
    watched("device-busy share of a fused round",
            results["fused"]["device_busy_share"], 0.5, True)
    return results


def profile_pipeline(torch, out):
    """The fused schedule's chunk loop pipelined (the driver's default)
    against serial (--no-pipeline), on the trained hybrid / mse_avg
    engine, whose graphs phase_train captured: 12 rounds in chunks of 2,
    each run from the engine's init and fresh streams (the same
    selections, draws and work), in the order pipelined, serial, serial,
    pipelined. `consume` does the driver's per-round host work (a
    ResultsWriter appends the round's metrics and verification rows).
    Reports each run's wall per round and the pipelined runs' host gaps;
    the two loops' final states must be the same bits."""
    from fedmse_tpu_torch.checkpointing import ResultsWriter
    from fedmse_tpu_torch.federation import run_pipelined_schedule
    engine = out["engine"]
    cfg = engine.cfg
    keep = engine.states.clone(), engine.host.copy(), engine.rngs
    root = os.path.join(ROOT, "build", "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    writer = ResultsWriter(root, cfg.network_size, "chip-smoke",
                           cfg.scen_name, cfg.metric, cfg.num_participants)
    rounds, chunk = 12, 2

    def consume(results, sec):
        for r in results:
            writer.append_round_metrics(0, r.round_index, r.client_metrics,
                                        engine.model_type,
                                        engine.update_type)
            writer.append_verification(0, r.round_index,
                                       r.verification_results)
        return None

    runs, final = [], {}
    for pipelined in (True, False, False, True):
        engine.reset_federation()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_pipelined_schedule(engine, 0, rounds, chunk, consume,
                                       can_rewind=False, pipelined=pipelined)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        final.setdefault(pipelined, engine.states.params.clone())
        runs.append({"pipelined": pipelined, "wall_s": wall,
                     "round_ms": wall * 1e3 / rounds,
                     "host_gap_ms": [g * 1e3 for g in stats.host_gaps]})
        log(f"[pipeline] {rounds} fused rounds in chunks of {chunk}, "
            f"{'pipelined' if pipelined else 'serial'}: {wall:.4f} s, "
            f"{wall * 1e3 / rounds:.3f} ms a round; host gaps (ms) "
            f"{[round(g * 1e3, 3) for g in stats.host_gaps]}")
    engine.states, engine.host, engine.rngs = keep
    shutil.rmtree(root, ignore_errors=True)
    if not torch.equal(final[True], final[False]):
        raise AssertionError("[pipeline] pipelined and serial chunk loops "
                             "ended on different params")
    ms = {p: [r["round_ms"] for r in runs if r["pipelined"] == p]
          for p in (True, False)}
    log(f"[pipeline] mean ms a round: pipelined "
        f"{np.mean(ms[True]):.3f}, serial {np.mean(ms[False]):.3f}")
    return {"rounds": rounds, "chunk": chunk, "runs": runs}


def phase_card_vs_cpu(torch, device, cfg, clients):
    """hybrid / fedprox, round 1 cut to one epoch (334 steps of the 5-client
    cohort), on the card and on the CPU's plain versions from one init:
    params 1e-4 scale-normalized per leaf. One epoch, because the quick-run
    schedule's later epochs sit on a loss plateau where Adam's normalized
    step turns a last-bit difference of a gradient into an O(1) parameter
    difference and flips early-stop decisions (a 1e-7 relative gradient
    perturbation on the CPU alone: 4e-7 after one epoch, 2.0 after five)."""
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.federation import init_client_states
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    c = cfg.replace(num_rounds=1, epochs=1)
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    init = init_client_states(make_model("hybrid", *DIMS, device="cpu"),
                              len(clients),
                              torch.Generator().manual_seed(SEED + 4),
                              device="cpu")
    params = []
    t0 = time.perf_counter()
    for where in (device, torch.device("cpu")):
        data = stack_clients(clients, dev_x, c.batch_size, device=where)
        out = run_combination(c, data, len(clients), "hybrid", "fedprox", 0,
                              states=init.to(where))
        params.append(out["engine"].states.params.cpu())
    card, cpu = params
    layout = ParamLayout(*DIMS)
    err = max(float((card[:, sl] - cpu[:, sl]).abs().max()
                    / cpu[:, sl].abs().max()) for sl in layout.slices())
    log(f"[card-cpu] hybrid/fedprox round 1, one epoch, from one init: "
        f"worst per-leaf "
        f"scaled param error {err:.3e} ({time.perf_counter() - t0:.1f} s)")
    if err > 1e-4:
        raise AssertionError(f"card vs CPU training: {err:.3e} > 1e-4")
    return err


# ---- the fault path (phase "robust") ---- #

# the fault path's flags, beside --attack-kind and --attack-start
FAULT_FLAGS = ["--chaos-dropout", "0.2", "--chaos-straggler", "0.1",
               "--chaos-crash", "0.3", "--chaos-broadcast-loss", "0.1",
               "--elastic-leave", "0.1", "--elastic-join", "0.3",
               "--elastic-preempt", "0.05"]


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fault_specs(attack_kind="scale", attack_start=1):
    """The attack, chaos and elastic specs the driver makes of
    `--attack-kind <kind> --attack-start <start>` and FAULT_FLAGS (its
    parser and main.fault_specs)."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.main import build_parser
    from fedmse_tpu_torch.main import fault_specs as driver_specs
    args = build_parser().parse_args(
        ["--dataset-config", "unused", "--attack-kind", attack_kind,
         "--attack-start", str(attack_start)] + FAULT_FLAGS)
    _, attack, chaos, elastic = driver_specs(args, ExperimentConfig())
    return dict(attack=attack, chaos=chaos, elastic=elastic)


def _hooks(specs):
    """RoundEngine keywords of the driver's fault specs."""
    from fedmse_tpu_torch.federation.attack import make_poison_fn
    return dict(poison_fn=make_poison_fn(specs["attack"]),
                chaos=specs["chaos"], elastic=specs["elastic"])


def _round_row(result, sec):
    return {"round": result.round_index + 1,
            "aggregator": result.aggregator,
            "crashed": result.crashed_aggregator,
            "selected": result.selected, "effective": result.effective,
            "rejected": {r["client_id"]: r["rejected_updates"]
                         for r in result.verification_results},
            "members": result.members,
            "generations": None if result.generations is None
            else result.generations.tolist(), "seconds": sec}


def _check_rejections(engine, results):
    """Every client that verifies an attacked broadcast rejects it. The
    host follows each client's verifier: who received the broadcast (up,
    not broadcast-lost, not the crashed aggregator, a member; the
    aggregator holds it), who saw one before (a join clears that), and the
    rejected counters, which must read +1 for every verifying receiver of
    an attacked round, 0 for a first contact and unchanged elsewhere.
    Returns the rounds' (verifying, rejecting) counts."""
    n = engine.n_real
    seen, rej = np.zeros(n, bool), np.zeros(n, np.int64)
    gen = np.zeros(n, np.int64)
    counts = []
    for r in results:
        joined = r.generations > gen
        seen[joined], rej[joined] = False, 0
        gen = r.generations
        if r.aggregator is None:
            counts.append((0, 0))
            continue
        masks = engine._chaos_masks(r.round_index, 1)
        got = ((masks.available[0][:n] > 0) & (masks.bcast_drop[0][:n] <= 0)
               & np.isin(np.arange(n), r.members))
        if r.crashed_aggregator is not None:
            got[r.crashed_aggregator] = False
        got[r.aggregator] = False
        attacked = engine.poison_fn.active(r.round_index, 1)[0] > 0
        rows = {row["client_id"]: row["rejected_updates"]
                for row in r.verification_results}
        verifying = got & seen
        for i in range(n):
            if i == r.aggregator:
                continue
            if not got[i]:
                want = rej[i]
            elif not seen[i]:
                want = 0  # first contact: accepted unconditionally
            elif attacked:
                want = rej[i] + 1
            else:
                want = rows[i]  # an honest broadcast: either way
            if rows[i] != want:
                raise AssertionError(
                    f"[robust] round {r.round_index + 1}: client {i} "
                    f"rejected counter {rows[i]}, expected {want} "
                    f"(received {bool(got[i])}, verified before "
                    f"{bool(seen[i])}, attacked {attacked})")
            rej[i] = rows[i]
        seen |= got
        counts.append((int(verifying.sum()),
                       int((verifying & attacked).sum())))
    return counts


def _profiled(torch, engine, r):
    """Device milliseconds (torch.profiler) of fused round r run from the
    engine's current state, which is restored afterwards, streams
    included."""
    from torch.profiler import ProfilerActivity, profile
    states, host = engine.states.clone(), engine.host.copy()
    rngs = engine.rngs.state_dict()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run_round_fused(r)
        _sync(torch, engine.device)
    engine.states, engine.host = states, host
    engine.rngs.load_state_dict(rngs)
    return sum(_device_us(e) for e in prof.key_averages()) / 1e3


def _timed(torch, engine, r):
    """(result, host ms) of fused round r."""
    _sync(torch, engine.device)
    t0 = time.perf_counter()
    result = engine.run_round_fused(r)
    _sync(torch, engine.device)
    return result, (time.perf_counter() - t0) * 1e3


def _rounds_alone(torch, engine, n_rounds):
    """The engine's first rounds again from its init and fresh streams, one
    fused round at a time: each profiled (on the card) for its device time,
    then run timed on the host clock. Returns [(result, wall_ms, busy_ms or
    None, epochs run)]."""
    engine.reset_federation()
    cuda = engine.device.type == "cuda"
    out = []
    for r in range(n_rounds):
        busy = _profiled(torch, engine, r) if cuda else None
        result, wall = _timed(torch, engine, r)
        out.append((result, wall, busy,
                    engine.fused_round().epochs_run[-1]))
    return out


def _first_round_ab(torch, engines, reps=3):
    """Round 1 of each engine from its init (the same work on every path
    that trains the whole selection), in turns a, b, b, a, ...: the host
    wall of each run, then one profiled run each. {name: {"wall_ms": [...],
    "busy_ms": x}}."""
    names = list(engines)
    order = (names + names[::-1]) * reps
    out = {k: {"wall_ms": []} for k in names}
    for k in order:
        engines[k].reset_federation()
        out[k]["wall_ms"].append(_timed(torch, engines[k], 0)[1])
    for k in names:
        engines[k].reset_federation()
        out[k]["busy_ms"] = (_profiled(torch, engines[k], 0)
                             if engines[k].device.type == "cuda" else None)
    return out


def robust_fault_run(torch, device, cfg, data, n):
    """(b) The fault path through the driver's run_combination on its
    default schedule (fused, pipelined, CUDA graphs), each round a chunk of
    its own so the roster churns between chunks: a scale attack from round
    1, chaos and elastic membership. Per round the aggregator, crashed
    aggregator, rejected counters, members and generations; every
    verifying client must reject the scaled broadcast, and each of the
    round's three bodies is captured once across the churning chunks.
    Returns (report, engine). `robust_round_times` then runs the same
    rounds one at a time from the init (the same masks: absolute rounds)
    for each round's wall and device-busy share, and round 1 in turns with
    a clean engine's from the same init, three times each (the same
    training: both paths train the whole selection)."""
    from fedmse_tpu_torch.main import run_combination
    c = cfg.replace(fused_schedule_chunk=1)
    rows = []
    out = run_combination(c, data, n, "hybrid", "mse_avg", 0,
                          on_round=lambda r, s: rows.append(_round_row(r, s)),
                          **fault_specs())
    engine = out["engine"]
    results = out["rounds"]
    counts = _check_rejections(engine, results)
    f = engine.fused_round()
    stats = f.stats()
    calls = len(results)
    for body in (f.enter, f.leave):
        if body.replays != calls - 1 and device.type == "cuda":
            raise AssertionError(f"[robust] the {body.name} body was "
                                 f"captured more than once: {body.replays}"
                                 f" replays in {calls} rounds")
    if not any(r.aggregator is not None for r in results[1:]):
        raise AssertionError("[robust] no attacked round aggregated")
    for row, (ver, rej) in zip(rows, counts):
        row.update(verifying=ver, rejecting=rej)
    if not sum(rej for _, rej in counts):
        raise AssertionError("[robust] no verifying client saw an attacked "
                             "broadcast: the rejection check held nothing")
    return {"rounds": rows, "fused": stats,
            "final_metrics": out["final_metrics"].tolist()}, engine


def robust_round_times(torch, report, engine):
    """(b, continued) The fault run's rounds one at a time from the init
    (docstring of robust_fault_run), and its round 1 in turns with a clean
    engine's."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    rows = report["rounds"]
    clean = RoundEngine(engine.model, engine.cfg, engine.data,
                        n_real=engine.n_real,
                        rngs=ExperimentRngs(run=0), model_type="hybrid",
                        update_type="mse_avg", fused=True)
    clean.run_round_fused(0)  # its capture, outside the timed rounds

    def share(busy, wall):
        return None if busy is None else busy / wall
    for row, (res, wall, busy, ep) in zip(
            rows, _rounds_alone(torch, engine, len(rows))):
        if (res.aggregator, res.crashed_aggregator, res.members) != (
                row["aggregator"], row["crashed"], row["members"]):
            raise AssertionError("[robust] round alone differs from the "
                                 f"chunked run: {row} vs {res}")
        row.update(alone_wall_ms=wall, device_busy_ms=busy,
                   busy_share=share(busy, wall), epochs=ep)
        log(f"[robust] round {row['round']}: aggregator {row['aggregator']}"
            f", crashed {row['crashed']}, effective {row['effective']} of "
            f"{row['selected']}, rejected {json.dumps(row['rejected'])} "
            f"({row['rejecting']} of {row['verifying']} verifying clients "
            f"rejected), members {row['members']}, generations "
            f"{row['generations']}; {row['seconds']:.4f} s in the run; "
            f"alone {wall:.2f} ms"
            + ("" if busy is None else f" ({100 * busy / wall:.1f}% busy)")
            + f", {ep} epochs")
    ab = _first_round_ab(torch, {"fault": engine, "clean": clean})
    for k, v in ab.items():
        v["mean_wall_ms"] = float(np.mean(v["wall_ms"]))
        v["busy_share"] = share(v["busy_ms"], v["mean_wall_ms"])
        log(f"[robust] round 1 in turns, {k}: wall (ms) "
            f"{[round(w, 3) for w in v['wall_ms']]}, mean "
            f"{v['mean_wall_ms']:.3f}"
            + ("" if v["busy_ms"] is None else
               f"; device {v['busy_ms']:.3f} ms "
               f"({100 * v['busy_share']:.1f}% busy)"))
    watched("fault-path round wall seconds, round 1 in turns",
            ab["fault"]["mean_wall_ms"] / 1e3, 0.5, False)
    report["first_round_ab"] = ab


def robust_null_hooks(torch, device, cfg, data, n):
    """(a) Every hook built in with null specs (an attack that never fires,
    a zero-probability ChaosSpec, a null ElasticSpec) against the clean
    fused round from one init: two rounds (a capture, then a replay), the
    same bits. The graphs' nodes with the hooks off and on, and the
    forward launches of each leave graph (the crash re-election reuses the
    vote's scores: no second launch)."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    model = make_model("hybrid", *DIMS, cfg.shrink_lambda, device=device)
    init = init_client_states(model, n, torch.Generator().manual_seed(
        SEED + 6), device=device)
    hooks = dict(poison_fn=make_poison_fn(AttackSpec(
        kind="noise", start_round=10 ** 6)), chaos=ChaosSpec(),
        elastic=ElasticSpec())
    engines = [RoundEngine(model, cfg, data, n_real=n,
                           rngs=ExperimentRngs(run=0), model_type="hybrid",
                           update_type="mse_avg", states=init, fused=True,
                           **kw) for kw in ({}, hooks)]
    runs = [e.run_rounds(0, 2) for e in engines]
    _sync(torch, device)
    for a, b in zip(*runs):
        same = (a.aggregator == b.aggregator
                and a.verification_results == b.verification_results
                and all(_same_bits(torch, getattr(a, f), getattr(b, f))
                        for f in ("client_metrics", "min_valid", "tracking")))
        if not same:
            raise AssertionError(f"[robust] null hooks changed round "
                                 f"{a.round_index + 1}")
    errs = _state_errs(torch, ParamLayout(*DIMS), engines[1].states,
                       engines[0].states)
    if max(errs.values()) != 0:
        raise AssertionError(f"[robust] null hooks changed the states: "
                             f"{json.dumps(errs)}")
    graphs = [e.fused_round().stats()["graphs"] for e in engines]
    nodes = {k: {g: graphs[i][g]["nodes"] for g in graphs[i]}
             for i, k in enumerate(("hooks_off", "hooks_on"))}
    kernels = {k: graphs[i]["leave"]["kernels_per_replay"]
               for i, k in enumerate(("hooks_off", "hooks_on"))}
    if device.type == "cuda" and kernels["hooks_on"].get(
            "fused_ae_forward") != kernels["hooks_off"].get(
            "fused_ae_forward"):
        raise AssertionError(f"[robust] the fault hooks changed the leave "
                             f"graph's forward launches: {kernels}")
    log(f"[robust] (a) null hooks bit-equal to the clean fused round over "
        f"2 rounds; graph nodes {json.dumps(nodes)}; leave kernels per "
        f"replay {json.dumps(kernels)}")
    return {"bit_equal": True, "nodes": nodes, "leave_kernels": kernels}


def robust_card_vs_cpu(torch, device, cfg, clients):
    """(c) The fault path's first round cut to one epoch, the attack on
    from round 0, on the card and on the CPU from one init, with the same
    masks (the streams are pure functions of the seed and the absolute
    round): states within 1e-4 scale-normalized; aggregator, crashed,
    effective cohort, members and generations equal. One round: a second
    one-epoch round already parts card and CPU by ~3e-4 (Adam on a
    plateau, ROADMAP queue 3; PERF.md section 6)."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(epochs=1)
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    init = init_client_states(make_model("hybrid", *DIMS, device="cpu"),
                              len(clients),
                              torch.Generator().manual_seed(SEED + 7),
                              device="cpu")
    runs = []
    for where in (device, torch.device("cpu")):
        eng = RoundEngine(make_model("hybrid", *DIMS, c.shrink_lambda,
                                     device=where), c,
                          stack_clients(clients, dev_x, c.batch_size,
                                        device=where),
                          n_real=len(clients), rngs=ExperimentRngs(run=0),
                          model_type="hybrid", update_type="mse_avg",
                          states=init.to(where), fused=True,
                          **_hooks(fault_specs(attack_start=0)))
        runs.append((eng.run_rounds(0, 1), eng.states))
    (card_res, card), (cpu_res, cpu) = runs
    for a, b in zip(card_res, cpu_res):
        for f in ("aggregator", "crashed_aggregator", "effective",
                  "members"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"[robust] (c) card vs CPU {f}: "
                                     f"{getattr(a, f)} vs {getattr(b, f)}")
        if not np.array_equal(a.generations, b.generations):
            raise AssertionError("[robust] (c) card vs CPU generations")
    errs = _state_errs(torch, ParamLayout(*DIMS), card, cpu)
    err = max(errs[k] for k in ("params", "prev_global", "hist_params"))
    log(f"[robust] (c) the fault path's round 1 at one epoch, card vs "
        f"CPU: aggregators {[r.aggregator for r in card_res]}, crashed "
        f"{[r.crashed_aggregator for r in card_res]}, members "
        f"{[r.members for r in card_res]} equal; worst scaled state error "
        f"{err:.3e} (limit 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"[robust] (c) card vs CPU: {json.dumps(errs)}")
    return {"max_scaled_err": err, "errs": errs}


def robust_noise_paths(torch, device, cfg, data, n):
    """(d) A noise attack on the fused and on the per-phase round, from one
    init and cohort, tie-break off: the same draws (drawn per absolute
    round on the host), states and results within 1e-6 (bit-equal
    expected)."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    import dataclasses
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(compat=dataclasses.replace(cfg.compat,
                                               vote_tie_break=False))
    model = make_model("hybrid", *DIMS, c.shrink_lambda, device=device)
    init = init_client_states(model, n, torch.Generator().manual_seed(
        SEED + 8), device=device)
    spec = AttackSpec(kind="noise", strength=0.05, start_round=0)
    per, fus = (RoundEngine(model, c, data, n_real=n,
                            rngs=ExperimentRngs(run=0), model_type="hybrid",
                            update_type="mse_avg", states=init, fused=fused,
                            poison_fn=make_poison_fn(spec))
                for fused in (False, True))
    want, got = per.run_round(0), fus.run_round(0)
    _sync(torch, device)
    if want.aggregator is None or got.aggregator != want.aggregator or \
            got.verification_results != want.verification_results:
        raise AssertionError("[robust] (d) noise attack: the paths elected "
                             f"{got.aggregator} vs {want.aggregator}")
    errs = _state_errs(torch, ParamLayout(*DIMS), fus.states, per.states)
    for field in ("client_metrics", "agg_weights", "min_valid", "tracking"):
        errs[field] = _nan_scaled_err(torch, getattr(got, field),
                                      getattr(want, field))
    err = max(errs.values())
    log(f"[robust] (d) noise attack, fused vs per-phase round: aggregator "
        f"{got.aggregator}, worst scaled error {err:.3e} (limit 1e-6; "
        f"bit-equal: {err == 0})")
    if err > 1e-6:
        raise AssertionError(f"[robust] (d) {json.dumps(errs)}")
    return {"max_scaled_err": err, "bit_equal": err == 0}


def robust_resume(torch, device, cfg, data, n):
    """(e) The fault path with --resume-dir: 2 rounds, then a resumed run
    to 3 (a fresh engine: restored states copied into newly captured
    graphs' buffers, the streams where they were), against 3 rounds
    uninterrupted: within 1e-6 (bit-equal expected)."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.checkpointing import CheckpointManager
    from fedmse_tpu_torch.main import run_combination
    root = os.path.join(ROOT, "build", "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(root)

    def run(rounds, resume):
        return run_combination(cfg.replace(num_rounds=rounds), data, n,
                               "hybrid", "mse_avg", 0, resume=resume,
                               **fault_specs())
    whole = run(3, None)
    first = run(2, mgr)
    rest = run(3, mgr)
    shutil.rmtree(root, ignore_errors=True)
    if (first["rounds_run"], rest["rounds_run"]) != (2, 1):
        raise AssertionError("[robust] (e) the resumed run did not continue "
                             "at round 3")
    for a, b in zip(first["rounds"] + rest["rounds"], whole["rounds"]):
        if (a.aggregator, a.crashed_aggregator, a.members) != (
                b.aggregator, b.crashed_aggregator, b.members):
            raise AssertionError(f"[robust] (e) round {a.round_index + 1} "
                                 "differs after the resume")
    errs = _state_errs(torch, ParamLayout(*DIMS), rest["engine"].states,
                       whole["engine"].states)
    errs["final_metrics"] = _nan_scaled_err(torch, rest["final_metrics"],
                                            whole["final_metrics"])
    err = max(errs.values())
    log(f"[robust] (e) 2 rounds, resumed to 3, vs 3 uninterrupted: worst "
        f"scaled error {err:.3e} (limit 1e-6; bit-equal: {err == 0})")
    if err > 1e-6:
        raise AssertionError(f"[robust] (e) {json.dumps(errs)}")
    return {"max_scaled_err": err, "bit_equal": err == 0}


def robust_knn_round(torch, device, cfg, data, n):
    """(f) One kNN-scored fault round (the evaluation's distance launch in
    the leave graph): present members' metrics finite, retired slots
    NaN."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(score_kind="knn", **KNN)
    eng = RoundEngine(make_model("hybrid", *DIMS, c.shrink_lambda,
                                 device=device), c, data, n_real=n,
                      rngs=ExperimentRngs(run=0), model_type="hybrid",
                      update_type="mse_avg", fused=True,
                      **_hooks(fault_specs()))
    res = eng.run_rounds(0, 2)[-1]
    present = np.isin(np.arange(n), res.members)
    if not np.isfinite(res.client_metrics[present]).all() or \
            not np.isnan(res.client_metrics[~present]).all():
        raise AssertionError(f"[robust] (f) kNN metrics {res.client_metrics}"
                             f" with members {res.members}")
    log(f"[robust] (f) kNN-scored fault round 2: aggregator "
        f"{res.aggregator}, members {res.members}, mean AUC "
        f"{np.nanmean(res.client_metrics):.6f}")
    return {"aggregator": res.aggregator, "members": res.members,
            "mean_auc": float(np.nanmean(res.client_metrics))}


def phase_robust(torch, device, cfg, clients, data):
    """The fault path (attack, chaos, elastic membership, resume) at the
    paper's width on the 10-gateway federation. (b) and (f) are the
    slice's main path: every kernel's launch counter is set to 0 before
    them and read after, and each must have launched. Then (a), (c), (d)
    and (e) hold the path to its references."""
    WRAPPERS = family_wrappers("autoencoder")
    n = len(clients)
    t0 = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    fault, engine = robust_fault_run(torch, device, cfg, data, n)
    report = {"fault_run": fault,
              "knn_round": robust_knn_round(torch, device, cfg, data, n)}
    _sync(torch, device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[robust] fault path launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the fault path never launched {name}")
    report["launches"] = launches
    seconds = {"b_f_fault_path": time.perf_counter() - t0}
    for name, step in (
            ("b_round_times", lambda: robust_round_times(torch, fault,
                                                         engine)),
            ("null_hooks", lambda: robust_null_hooks(torch, device, cfg,
                                                     data, n)),
            ("card_vs_cpu", lambda: robust_card_vs_cpu(torch, device, cfg,
                                                       clients)),
            ("noise_paths", lambda: robust_noise_paths(torch, device, cfg,
                                                       data, n)),
            ("resume", lambda: robust_resume(torch, device, cfg, data, n))):
        t1 = time.perf_counter()
        result = step()
        seconds[name] = time.perf_counter() - t1
        if result is not None:
            report[name] = result
    report["seconds"] = time.perf_counter() - t0
    report["phase_seconds"] = seconds
    log(f"[robust] done in {report['seconds']:.1f} s "
        f"({json.dumps({k: round(v, 2) for k, v in seconds.items()})})")
    return report


# the [cluster] phase: the typed fleet the clustered federation is measured
# on (4 device types, 8.0 apart), at the paper's width
CLUSTER_FLEET = dict(n_clients=16, types=4, dim=DIMS[0], n_normal=10_000,
                     n_abnormal=2_000, modes=3, seed=11)
CLUSTER_K = 4
# (d) runs until these rounds' joins were all checked: slots 7 (round 2),
# 5 (round 4) and 4 and 7 (round 5) join under --elastic-join 0.3
# --elastic-leave 0.1 at 16 slots (the run's elastic stream, run 0)
CLUSTER_ELASTIC_ROUNDS = 5


def cluster_fleet(cfg, devices):
    """The typed fleet stacked on each of `devices`."""
    from fedmse_tpu_torch.data import (build_dev_dataset, stack_clients,
                                       synthetic_typed_clients)
    clients = synthetic_typed_clients(**CLUSTER_FLEET)
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    return [stack_clients(clients, dev_x, cfg.batch_size, device=d)
            for d in devices]


def cluster_kernel_shapes(torch, device, data, n):
    """The forward kernel at the clustered path's own launches, against its
    plain version in f32 on dyadic grids (phase_kernels' rule): the probe
    encode (one model over every gateway's train rows) and the per-client
    verification (n models client-major over the shared rows); then the
    routed verification launch (the 2n models of the hardened rule, the
    broadcasts all one model) against the uniform launch of that model:
    the same bits. The train kernel at the cohort's step (n / 2 clients x
    12 rows) and the distance kernel at the kNN evaluation's rows (n banks)
    against theirs. Returns the worst scaled errors."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 11)
    layout = ParamLayout(*DIMS)
    probe_rows = n * data.train_xb.shape[1] * data.train_xb.shape[2]
    ver_rows = data.valid_x.shape[1]
    worst = {}
    for what, g, rows, idx in (
            ("probe encode", 1, probe_rows, None),
            ("per-client verification", n, n * ver_rows, "client_major")):
        params = grid_params(torch, g, *DIMS, gen, device, torch.float32)
        x = (torch.randint(-6, 7, (rows, DIMS[0]), generator=gen) / 4.0
             ).to(device)
        index = None if idx is None else forward_index(torch, idx, g, rows,
                                                       gen, device)
        got = fused_forward_stats(params, x, index)
        want = fused_forward_stats_plain(params, x, index)
        err = max(scaled_err(a, b) for a, b in zip(got, want))
        if err > TOL["f32"]:
            raise AssertionError(f"[cluster] forward kernel vs plain, {what}"
                                 f" (G={g}, R={rows}): {err:.3e}")
        worst[what] = err
    # the routed 2n-model launch: own models 0..n-1, broadcasts n..2n-1 all
    # one model; each broadcast row must be that model's uniform-launch bits
    own = random_flat(torch, layout, n, gen, device)
    bcast = random_flat(torch, layout, 1, gen, device)
    x = torch.randn((ver_rows, DIMS[0]), generator=gen).to(device)
    models = torch.cat([bcast.expand(n, -1), own])
    ids = torch.arange(n, device=device, dtype=torch.int32)
    route = torch.cat([ids, ids + n])[:, None].repeat(1, ver_rows).view(-1)
    routed = fused_forward_stats(layout.tree(models),
                                 x.repeat(2 * n, 1), route)
    uniform = fused_forward_stats(layout.tree(bcast), x, None)
    for r, u in zip(routed, uniform):
        head = r[: n * ver_rows].view((n, ver_rows) + tuple(u.shape[1:]))
        if not torch.equal(head.view(torch.int32),
                           u[None].expand_as(head).view(torch.int32)):
            raise AssertionError("[cluster] the routed verification launch "
                                 "differs from the uniform launch's bits")
    cohort = n // 2
    flat, xt = grid_inputs(torch, layout, cohort, 12, gen, device)
    m = torch.ones((cohort, 12), device=device)
    kw = dict(layout=layout, shrink_lambda=10.0)
    worst["train step, cohort"] = max(
        scaled_err(a, b) for a, b in zip(fused_train_grads(flat, xt, m, **kw),
                                         fused_train_grads_plain(flat, xt, m,
                                                                 **kw)))
    if worst["train step, cohort"] > TOL["f32"]:
        raise AssertionError(f"[cluster] train kernel vs plain at G="
                             f"{cohort}: {worst['train step, cohort']:.3e}")
    q, banks, gw = dist_inputs(torch, n, n * data.test_x.shape[1],
                               KNN["knn_bank_size"], DIMS[2], "client_major",
                               gen, device, torch.float32)
    _, _, worst["distances, kNN evaluation"] = dist_check(
        torch, q, banks, gw, f"[cluster] kNN evaluation, {n} banks")
    log(f"[cluster] kernels at the clustered path's shapes agree with their "
        f"plain versions (routed verification = uniform bits): "
        f"{json.dumps(worst)}")
    return worst


@contextlib.contextmanager
def _cluster_stash():
    """Keep, by reference, a copy of the post-training params the fused
    round's local training hands back (LocalTrainer.finish, before any
    merge or broadcast touches them). Captured in a CUDA graph, the copy
    holds what the last replay wrote."""
    from fedmse_tpu_torch.federation.local_training import LocalTrainer
    stash = {}
    finish = LocalTrainer.finish

    def keep_trained(self, *args, **kwargs):
        res = finish(self, *args, **kwargs)
        stash["trained"] = res.params.clone()
        return res
    LocalTrainer.finish = keep_trained
    try:
        yield stash
    finally:
        LocalTrainer.finish = finish


def _host_merges(result, trained, assignment, k):
    """[K, P] f64: each cluster's merge rebuilt on the host from the
    round's post-training params and its aggregation weights (each
    client's weight inside its own cluster's merge), one cluster at a
    time. Checks the weights first: zero off the selected cohort, summing
    to 1 in every cluster with a selected member."""
    w = np.asarray(result.agg_weights, np.float64)
    selected = np.zeros(len(w), bool)
    selected[result.selected] = True
    if np.abs(w[~selected]).max(initial=0.0) != 0.0:
        raise AssertionError(f"[cluster] weight off the cohort: {w}")
    n = len(assignment)
    w, selected, trained = w[:n], selected[:n], trained[:n].cpu().double()
    merges = trained.new_zeros((k, trained.shape[1]))
    for c in range(k):
        mine = assignment == c
        if not (mine & selected).any():
            continue
        if abs(w[mine].sum() - 1.0) > 1e-6:
            raise AssertionError(f"[cluster] cluster {c}'s weights sum to "
                                 f"{w[mine].sum()}")
        for i in np.flatnonzero(mine & selected):
            merges[c] += float(w[i]) * trained[i]
    return merges


def _encoder_columns(torch, layout):
    """[P] bool: the encoder's columns (W1, b1, W2, b2), from the layout's
    own offsets."""
    cols = torch.zeros(layout.size, dtype=torch.bool)
    for (coder, _, _), off, shape in layout.leaves():
        if coder == "encoder":
            cols[off: off + int(np.prod(shape))] = True
    return cols


def _accepting(result, assignment, k):
    """[n] bool: who loaded its cluster's broadcast in `result`'s round (no
    fault hooks): the aggregator, and every client of a cluster with a
    selected member (a merge was made) whose rejected counter reads 0."""
    n = len(assignment)
    has_update = np.zeros(k, bool)
    has_update[assignment[result.selected]] = True
    rejected = {r["client_id"]: r["rejected_updates"]
                for r in result.verification_results}
    out = np.zeros(n, bool)
    if result.aggregator is None:
        return out
    for i in range(n):
        out[i] = i == result.aggregator or (
            has_update[assignment[i]] and rejected[i] == 0)
    return out


def cluster_driver_run(torch, cfg, data, n, init, spec, keep=True):
    """run_combination (autoencoder / mse_avg, the driver's default fused,
    pipelined schedule) from `init` under `spec`; with `keep`, the last
    round's post-training params stashed (one copy node in the leave
    graph)."""
    from fedmse_tpu_torch.main import run_combination
    with (_cluster_stash() if keep else contextlib.nullcontext({})) as stash:
        out = run_combination(cfg, data, n, "autoencoder", "mse_avg", 0,
                              states=init, cluster=spec)
    _sync(torch, data.train_xb.device)
    return out, stash


def cluster_main_run(torch, cfg, data, cpu_data, n, init):
    """(b) --cluster-k 4, autoencoder / mse_avg: the card's fit equals the
    plain path's fit on the CPU from the same states; its purity against
    the device types; every client that accepted the last round's
    broadcast holds its own cluster's merge as the host rebuilds it in f64
    from the round's post-training params and weights (<= 1e-6
    scale-normalized)."""
    from fedmse_tpu_torch.cluster import ClusterSpec, fit_from_states
    from fedmse_tpu_torch.models import make_model
    spec = ClusterSpec(k=CLUSTER_K)
    out, stash = cluster_driver_run(torch, cfg, data, n, init, spec)
    engine = out["engine"]
    a = engine.cluster_assignment
    cpu_fit = fit_from_states(
        make_model("autoencoder", *DIMS, device="cpu"), spec,
        init.params.cpu(), cpu_data.train_xb, cpu_data.train_mb,
        cpu_data.client_mask, n)
    if not np.array_equal(cpu_fit.assignment, a):
        raise AssertionError(f"[cluster] (b) the card's assignment {a} is "
                             f"not the CPU's {cpu_fit.assignment}")
    types = np.arange(n) % CLUSTER_FLEET["types"]
    purity = sum(np.bincount(types[a == c]).max() for c in set(a.tolist())
                 ) / n
    last = out["rounds"][-1]
    accept = _accepting(last, a, CLUSTER_K)
    if not accept.any():
        raise AssertionError("[cluster] (b) no client accepted the last "
                             "round's broadcast: the merge check held "
                             "nothing")
    merged = _host_merges(last, stash["trained"], a, CLUSTER_K)
    params = engine.states.params.cpu()
    err = max(scaled_err(params[i], merged[a[i]])
              for i in np.flatnonzero(accept))
    if err > 1e-6:
        raise AssertionError(f"[cluster] (b) an accepting client holds "
                             f"another model than its cluster's merge: {err}")
    fit = engine.cluster_fit_seconds
    report = {"assignment": a.tolist(),
              "sizes": np.bincount(a, minlength=CLUSTER_K).tolist(),
              "purity": purity, "cpu_fit_equal": True,
              "accepting_last_round": int(accept.sum()),
              "merge_max_scaled_err": err,
              "aggregators": [r.aggregator for r in out["rounds"]],
              "fit_seconds": fit,
              "final_auc_mean": float(np.mean(out["final_metrics"])),
              "final_auc_min": float(np.min(out["final_metrics"]))}
    log(f"[cluster] (b) --cluster-k {CLUSTER_K}: assignment {a.tolist()} "
        f"(sizes {report['sizes']}, purity {purity:.3f} against the device "
        f"types), the CPU's fit from the same states equal; fit "
        f"{json.dumps(fit)}; aggregators {report['aggregators']}; "
        f"{int(accept.sum())} clients accepted the last broadcast, each "
        f"holding its cluster's merge (worst scaled error {err:.3e}, limit "
        f"1e-6)")
    return report, engine


def cluster_knn_round(torch, device, cfg, data, n, assignment):
    """(g) One kNN-scored clustered round (the distance launch in the leave
    graph): every metric finite."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(score_kind="knn", **KNN)
    eng = RoundEngine(make_model("autoencoder", *DIMS, device=device), c,
                      data, n_real=n, rngs=ExperimentRngs(run=0),
                      model_type="autoencoder", update_type="mse_avg",
                      fused=True, cluster=ClusterSpec(k=CLUSTER_K),
                      cluster_assignment=assignment)
    res = eng.run_round_fused(0)
    if not np.isfinite(res.client_metrics).all():
        raise AssertionError(f"[cluster] (g) kNN metrics "
                             f"{res.client_metrics}")
    log(f"[cluster] (g) kNN-scored clustered round: aggregator "
        f"{res.aggregator}, mean AUC {np.mean(res.client_metrics):.6f}")
    return {"aggregator": res.aggregator,
            "mean_auc": float(np.mean(res.client_metrics))}


def cluster_null(torch, cfg, data, n, init):
    """(a) ClusterSpec(k=1) against no spec from one init through the
    driver: states and every round's results bit-equal, the same graphs
    (nodes and kernels per replay)."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.models.flat import ParamLayout
    plain, _ = cluster_driver_run(torch, cfg, data, n, init, None,
                                  keep=False)
    null, _ = cluster_driver_run(torch, cfg, data, n, init,
                                 ClusterSpec(k=1), keep=False)
    errs = _state_errs(torch, ParamLayout(*DIMS), null["engine"].states,
                       plain["engine"].states)
    same = max(errs.values()) == 0 and all(
        a.aggregator == b.aggregator
        and a.verification_results == b.verification_results
        and all(_same_bits(torch, getattr(a, f), getattr(b, f))
                for f in ("client_metrics", "min_valid", "tracking"))
        for a, b in zip(null["rounds"], plain["rounds"]))
    graphs = [o["engine"].fused_round().stats()["graphs"]
              for o in (plain, null)]
    shape = [{g: (s["nodes"], s["kernels_per_replay"]) for g, s in x.items()}
             for x in graphs]
    if not same or shape[0] != shape[1]:
        raise AssertionError(f"[cluster] (a) ClusterSpec(k=1) differs from "
                             f"no spec: {json.dumps(errs)}, graphs {shape}")
    nodes = {g: s["nodes"] for g, s in graphs[0].items()}
    log(f"[cluster] (a) ClusterSpec(k=1) bit-equal to no spec over "
        f"{len(plain['rounds'])} rounds; graph nodes equal {nodes}")
    return {"bit_equal": True, "nodes": nodes}, plain


def cluster_personalized(torch, cfg, data, n, init):
    """(c) --cluster-k 4 --cluster-personalize: after the last round every
    client's decoder columns are its own post-training params, bit for
    bit, and every accepting client's encoder columns its cluster's merge
    as the host rebuilds it in f64 (<= 1e-6 scale-normalized)."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.models.flat import ParamLayout
    out, stash = cluster_driver_run(torch, cfg, data, n, init,
                                    ClusterSpec(k=CLUSTER_K,
                                                personalize=True))
    engine = out["engine"]
    a = engine.cluster_assignment
    last = out["rounds"][-1]
    accept = _accepting(last, a, CLUSTER_K)
    if not accept.any():
        raise AssertionError("[cluster] (c) no client accepted the last "
                             "round's broadcast: the encoder check held "
                             "nothing")
    enc = _encoder_columns(torch, ParamLayout(*DIMS))
    params = engine.states.params.cpu()
    trained = stash["trained"].cpu()
    own = [int(i) for i in range(n)
           if not torch.equal(params[i][~enc], trained[i][~enc])]
    if own:
        raise AssertionError(f"[cluster] (c) clients {own} do not hold "
                             "their own post-training decoder")
    merged = _host_merges(last, trained, a, CLUSTER_K)
    err = max(scaled_err(params[i][enc], merged[a[i]][enc])
              for i in np.flatnonzero(accept))
    if err > 1e-6:
        raise AssertionError(f"[cluster] (c) an accepting client's encoder "
                             f"is not its cluster's merge: {err:.3e}")
    log(f"[cluster] (c) --cluster-personalize: every client holds its own "
        f"post-training decoder, bit for bit; {int(accept.sum())} accepting "
        f"clients hold their cluster's encoder (worst scaled error "
        f"{err:.3e} against the host's f64 merge, limit 1e-6); final mean "
        f"AUC {np.mean(out['final_metrics']):.6f}")
    return {"accepting_last_round": int(accept.sum()),
            "decoder_bit_equal": True, "encoder_max_scaled_err": err,
            "final_auc_mean": float(np.mean(out["final_metrics"]))}


def cluster_elastic(torch, cfg, data, n, init, assignment):
    """(d) (b) with --elastic-join 0.3 --elastic-leave 0.1 --chaos-dropout
    0.2 on the serial chunk loop, a round a chunk: after each round the
    host checks every joiner of that round against the pre-entry params,
    in f64: its cluster's incumbent mean, or the fleet's when its cluster
    has no incumbent (<= 1e-6 scale-normalized). The fit from the same
    init is (b)'s `assignment`."""
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    from fedmse_tpu_torch.federation.fused import FusedRound
    from fedmse_tpu_torch.main import run_combination
    stash, checked = {}, []
    original = FusedRound._join_and_leave

    def join_and_keep(self):
        stash["pre"] = self.states.params.clone()
        original(self)
        stash["post"] = self.states.params.clone()
        stash["joined"] = self.round_in["joined"].clone()
        stash["member"] = self.round_in["member"].clone()

    def on_round(result, sec):
        joined = stash["joined"].cpu().numpy() > 0
        pre = stash["pre"].cpu().double()
        post = stash["post"].cpu().double()
        inc = (stash["member"].cpu().numpy() > 0) & ~joined
        for j in np.flatnonzero(joined):
            mine = inc & (assignment == assignment[j])
            want = pre[torch.from_numpy(mine if mine.any() else inc)].mean(
                dim=0)
            err = scaled_err(post[j], want)
            checked.append({"round": result.round_index + 1, "slot": int(j),
                            "cluster": int(assignment[j]),
                            "from": "cluster" if mine.any() else "fleet",
                            "scaled_err": err})
            if err > 1e-6:
                raise AssertionError(f"[cluster] (d) joiner {j} in round "
                                     f"{result.round_index + 1}: {err:.3e}")

    FusedRound._join_and_leave = join_and_keep
    try:
        out = run_combination(
            cfg.replace(num_rounds=CLUSTER_ELASTIC_ROUNDS,
                        fused_schedule_chunk=1, fused_pipeline=False),
            data, n, "autoencoder", "mse_avg", 0, states=init,
            cluster=ClusterSpec(k=CLUSTER_K),
            elastic=ElasticSpec(leave_p=0.1, join_p=0.3),
            chaos=ChaosSpec(dropout_p=0.2), on_round=on_round)
    finally:
        FusedRound._join_and_leave = original
    if not np.array_equal(out["engine"].cluster_assignment, assignment):
        raise AssertionError("[cluster] (d) the fit from the same init "
                             "differs from (b)'s")
    if not checked:
        raise AssertionError("[cluster] (d) no slot joined: the inheritance "
                             "check held nothing")
    log(f"[cluster] (d) elastic + chaos, {CLUSTER_ELASTIC_ROUNDS} rounds: "
        f"joiners {json.dumps(checked)}; members "
        f"{[r.members for r in out['rounds']]}, aggregators "
        f"{[r.aggregator for r in out['rounds']]}")
    return {"joiners": checked,
            "aggregators": [r.aggregator for r in out["rounds"]]}


def cluster_card_vs_cpu(torch, device, cfg, data, cpu_data, n, init,
                        assignment):
    """(e) Round 1 cut to one epoch, K = 4 under (b)'s assignment, on the
    card and on the CPU from one init: the same aggregator and
    verification rows, every state leaf within 1e-4 scale-normalized."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(epochs=1)
    runs = []
    for where, d in ((device, data), (torch.device("cpu"), cpu_data)):
        eng = RoundEngine(make_model("autoencoder", *DIMS, device=where), c,
                          d, n_real=n, rngs=ExperimentRngs(run=0),
                          model_type="autoencoder", update_type="mse_avg",
                          states=init.to(where), fused=True,
                          cluster=ClusterSpec(k=CLUSTER_K),
                          cluster_assignment=assignment)
        runs.append((eng.run_rounds(0, 1)[0], eng.states))
    (card_res, card), (cpu_res, cpu) = runs
    if (card_res.aggregator, card_res.verification_results) != (
            cpu_res.aggregator, cpu_res.verification_results):
        raise AssertionError(f"[cluster] (e) card vs CPU: aggregator "
                             f"{card_res.aggregator} vs {cpu_res.aggregator}")
    errs = _state_errs(torch, ParamLayout(*DIMS), card, cpu)
    err = max(errs[k] for k in ("params", "prev_global", "hist_params"))
    log(f"[cluster] (e) round 1 at one epoch, card vs CPU: aggregator "
        f"{card_res.aggregator}; worst scaled state error {err:.3e} (limit "
        f"1e-4)")
    if err > 1e-4:
        raise AssertionError(f"[cluster] (e) card vs CPU: {json.dumps(errs)}")
    return {"max_scaled_err": err, "errs": errs}


def cluster_resume(torch, cfg, data, n, init):
    """(f) --cluster-k 4 --cluster-refit-every 1 a round a chunk with
    --resume-dir: 2 rounds, then a resumed run to 3 (the recorded
    assignment and fit round re-pinned), against 3 uninterrupted: bit-equal
    (limit 1e-6)."""
    from fedmse_tpu_torch.checkpointing import CheckpointManager
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.models.flat import ParamLayout
    root = os.path.join(ROOT, "build", "chip_smoke_cluster_resume")
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(root)
    spec = ClusterSpec(k=CLUSTER_K, refit_every=1)

    def run(rounds, resume):
        return run_combination(cfg.replace(num_rounds=rounds,
                                           fused_schedule_chunk=1),
                               data, n, "autoencoder", "mse_avg", 0,
                               states=init, resume=resume, cluster=spec)
    whole = run(3, None)
    first = run(2, mgr)
    rest = run(3, mgr)
    shutil.rmtree(root, ignore_errors=True)
    if (first["rounds_run"], rest["rounds_run"]) != (2, 1):
        raise AssertionError("[cluster] (f) the resumed run did not continue"
                             " at round 3")
    for a, b in zip(first["rounds"] + rest["rounds"], whole["rounds"]):
        if a.aggregator != b.aggregator:
            raise AssertionError(f"[cluster] (f) round {a.round_index + 1} "
                                 "differs after the resume")
    errs = _state_errs(torch, ParamLayout(*DIMS), rest["engine"].states,
                       whole["engine"].states)
    errs["final_metrics"] = _nan_scaled_err(torch, rest["final_metrics"],
                                            whole["final_metrics"])
    err = max(errs.values())
    fits = whole["engine"].cluster_fit_seconds
    log(f"[cluster] (f) 2 rounds, resumed to 3, vs 3 uninterrupted (fits "
        f"{json.dumps(fits)}): worst scaled error {err:.3e} (limit 1e-6; "
        f"bit-equal: {err == 0})")
    if err > 1e-6:
        raise AssertionError(f"[cluster] (f) {json.dumps(errs)}")
    return {"max_scaled_err": err, "bit_equal": err == 0, "fits": fits}


def cluster_round_times(torch, device, cfg, data, n, init, assignment):
    """Round 1 of the clustered engine (K = 4, (b)'s assignment pinned, so
    no fit inside the timed round) and of the clean engine, from one init,
    in turns a, b, b, a (_first_round_ab): host wall, device time, busy
    share; the graphs' nodes of both."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    engines = {}
    for name, kw in (("cluster", dict(cluster=ClusterSpec(k=CLUSTER_K),
                                      cluster_assignment=assignment)),
                     ("clean", {})):
        engines[name] = RoundEngine(
            make_model("autoencoder", *DIMS, device=device), cfg, data,
            n_real=n, rngs=ExperimentRngs(run=0), model_type="autoencoder",
            update_type="mse_avg", states=init, fused=True, **kw)
        engines[name].run_round_fused(0)  # its capture, untimed
    ab = _first_round_ab(torch, engines)
    for k, v in ab.items():
        v["mean_wall_ms"] = float(np.mean(v["wall_ms"]))
        v["busy_share"] = (None if v["busy_ms"] is None
                           else v["busy_ms"] / v["mean_wall_ms"])
        v["nodes"] = {g: s["nodes"] for g, s in
                      engines[k].fused_round().stats()["graphs"].items()}
        log(f"[cluster] round 1 in turns, {k}: wall (ms) "
            f"{[round(w, 3) for w in v['wall_ms']]}, mean "
            f"{v['mean_wall_ms']:.3f}"
            + ("" if v["busy_ms"] is None else
               f"; device {v['busy_ms']:.3f} ms "
               f"({100 * v['busy_share']:.1f}% busy)")
            + f"; graph nodes {v['nodes']}")
    watched("clustered round wall seconds, round 1 in turns",
            ab["cluster"]["mean_wall_ms"] / 1e3, 0.5, False)
    return ab


def phase_cluster(torch, device, cfg):
    """Clustered federation on the typed fleet (16 gateways of 4 device
    types at 115/27/7) with the quick run's schedule, autoencoder /
    mse_avg. (b) and (g) are the slice's main path: every kernel's launch
    counter is set to 0 before them and read after, and each must have
    launched. Then (a), (c), (d), (e), (f) hold the path to its
    references, and the clustered round is timed beside the clean one."""
    from fedmse_tpu_torch.federation import init_client_states
    from fedmse_tpu_torch.models import make_model
    WRAPPERS = family_wrappers("autoencoder")
    t0 = time.perf_counter()
    data, cpu_data = cluster_fleet(cfg, (device, torch.device("cpu")))
    n = CLUSTER_FLEET["n_clients"]
    init = init_client_states(make_model("autoencoder", *DIMS,
                                         device=device), n,
                              torch.Generator().manual_seed(SEED + 12),
                              device=device)
    report = {"fleet": CLUSTER_FLEET,
              "kernels": cluster_kernel_shapes(torch, device, data, n)}
    seconds = {"setup": time.perf_counter() - t0}
    t1 = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    report["k4"], engine = cluster_main_run(torch, cfg, data, cpu_data, n,
                                            init)
    a = engine.cluster_assignment
    report["knn_round"] = cluster_knn_round(torch, device, cfg, data, n, a)
    _sync(torch, device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[cluster] clustered path launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the clustered path never launched {name}")
    report["launches"] = launches
    seconds["b_g_cluster_path"] = time.perf_counter() - t1
    for name, step in (
            ("null", lambda: cluster_null(torch, cfg, data, n, init)),
            ("personalized", lambda: cluster_personalized(torch, cfg, data,
                                                          n, init)),
            ("elastic", lambda: cluster_elastic(torch, cfg, data, n, init,
                                                a)),
            ("card_vs_cpu", lambda: cluster_card_vs_cpu(
                torch, device, cfg, data, cpu_data, n, init, a)),
            ("resume", lambda: cluster_resume(torch, cfg, data, n, init)),
            ("round_times", lambda: cluster_round_times(
                torch, device, cfg, data, n, init, a))):
        t1 = time.perf_counter()
        result = step()
        seconds[name] = time.perf_counter() - t1
        if name == "null":
            result, plain = result
            k1 = plain["final_metrics"]
            report["k1_final_auc_mean"] = float(np.mean(k1))
            report["k1_final_auc_min"] = float(np.min(k1))
            log(f"[cluster] final AUC, K = {CLUSTER_K} against K = 1 from "
                f"one init: mean {report['k4']['final_auc_mean']:.6f} vs "
                f"{report['k1_final_auc_mean']:.6f}, min "
                f"{report['k4']['final_auc_min']:.6f} vs "
                f"{report['k1_final_auc_min']:.6f}")
        report[name] = result
    report["seconds"] = time.perf_counter() - t0
    report["phase_seconds"] = seconds
    log(f"[cluster] done in {report['seconds']:.1f} s "
        f"({json.dumps({k: round(v, 2) for k, v in seconds.items()})})")
    return report


# ---- the red team (phase "redteam") ---- #

REDTEAM_K = 2
# (c)'s join blitz on the typed fleet: half the slots open, then from
# round 2 on the retired ones fill fast and the coalition rides in
REDTEAM_SYBIL = dict(rounds=5, join_p=0.9, initial_member_frac=0.5,
                     join_start=2, min_tenure=6)


def _red_engine(torch, cfg, data, n, init, assignment=None, spec=None,
                **kw):
    """A fused RoundEngine (autoencoder / mse_avg) from `init` on the typed
    fleet: clustered at K = 2 under the pinned `assignment` (unless None),
    with the red team `spec`."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    dev = data.train_xb.device
    if assignment is not None:
        kw.update(cluster=ClusterSpec(k=REDTEAM_K),
                  cluster_assignment=assignment)
    return RoundEngine(make_model("autoencoder", *DIMS, device=dev), cfg,
                       data, n_real=n, rngs=ExperimentRngs(run=0),
                       model_type="autoencoder", update_type="mse_avg",
                       states=init.to(dev), fused=True, redteam=spec, **kw)


def _accomplices(cfg, n, assignment):
    """(selection, voter, accomplice): run 0's first selection, its first
    voter with a candidate (a selected client of its own cluster), and
    that voter's earliest-selected cluster-mate."""
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    sel = ExperimentRngs(run=0).select_rng.sample(
        range(n), max(1, int(cfg.num_participants * n)))
    for voter in sel:
        mates = [c for c in sel if c != voter
                 and assignment[c] == assignment[voter]]
        if mates:
            return sel, voter, mates[0]
    raise AssertionError("[redteam] no selected client has a cluster-mate")


@contextlib.contextmanager
def _merge_stash():
    """Keep, by reference, the params the clustered merge reads (after the
    update stage) and the [K, P] cluster merges it broadcasts (after every
    poison). Captured in a CUDA graph, the copies hold what the last
    replay wrote."""
    from fedmse_tpu_torch.federation import fused
    stash = {}
    merge, gather = fused.FusedRound._merge, fused.gather_cluster_rows

    def keep_merge(self, st, agg_mask, aggregator):
        stash["params"] = st.params.clone()
        return merge(self, st, agg_mask, aggregator)

    def keep_rows(cluster_params, cluster_in):
        stash["merges"] = cluster_params.clone()
        return gather(cluster_params, cluster_in)
    fused.FusedRound._merge = keep_merge
    fused.gather_cluster_rows = keep_rows
    try:
        yield stash
    finally:
        fused.FusedRound._merge = merge
        fused.gather_cluster_rows = gather


MIMIC_BLENDS = (0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0)


def redteam_mimicry(torch, cfg, data, n, init):
    """(d) redteam_sweep.py's mimicry cell on the typed fleet's K = 2 fit
    from `init` (on the card): two gateways outside the victim cluster
    (gateway 0's) forge their latent statistics toward the victim's pooled
    Gaussian, at each blend of MIMIC_BLENDS; the plain refit and
    hysteresis 0.5 each move some of them in. The quick cell's criterion
    (plain capture >= 0.5, hysteresis at most half of it) must hold at
    some blend, perfect mimicry (1.0) must capture (no statistics-based
    defense can tell it apart), and hysteresis must never capture more
    than the plain refit. The quick cell fixes the blend at 0.8: where the
    window lies depends on the fit, and so on the init, which the port
    cannot draw as jax.random does (its 0.8 row is reported). Returns
    (report, the fit's assignment)."""
    from fedmse_tpu_torch.cluster import (ClusterSpec, fit_from_states,
                                          refit_with_hysteresis)
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.redteam import (assignment_capture_rate,
                                          mimic_latent_stats)
    dev = data.train_xb.device
    fit = fit_from_states(make_model("autoencoder", *DIMS, device=dev),
                          ClusterSpec(k=REDTEAM_K), init.params.to(dev),
                          data.train_xb, data.train_mb, data.client_mask, n)
    a = fit.assignment
    victim = int(a[0])
    adv = tuple(int(i) for i in np.flatnonzero(a != victim)[:2])
    captures = {}
    for blend in MIMIC_BLENDS:
        fm, fc = mimic_latent_stats(fit.means, fit.covs, adv,
                                    fit.cl_means[victim],
                                    fit.cl_covs[victim], blend)
        captures[blend] = [assignment_capture_rate(
            refit_with_hysteresis(fm, fc, a, REDTEAM_K, h,
                                  device=dev).assignment, adv, victim)
            for h in (0.0, 0.5)]
    window = [b for b, (plain, held) in captures.items()
              if plain >= 0.5 and held <= 0.5 * plain]
    log(f"[redteam] (d) mimicry on the K = {REDTEAM_K} fit {a.tolist()}: "
        f"gateways {list(adv)} into cluster {victim}; capture (plain refit, "
        f"hysteresis 0.5) by blend {json.dumps(captures)}; the quick "
        f"cell's criterion holds at blends {window}")
    if not window or captures[1.0][0] < 0.5 or any(
            held > plain for plain, held in captures.values()):
        raise AssertionError(f"[redteam] (d) captures {captures}")
    return {"assignment": a.tolist(), "victim": victim,
            "adversaries": list(adv), "capture_by_blend": captures,
            "defended_blends": window,
            "blend_0.8": captures[0.8]}, a


def redteam_merge_poison(torch, cfg, data, n, init, assignment):
    """(b) A merge-stage cluster_poison on the clustered round (K = 2):
    round 1 from `init`, one selection; the first voter and its
    earliest-selected cluster-mate are the coalition (sign_flip x2, the
    victim their cluster, lie_votes), so the voter elects the mate and
    the mate's merge is poisoned. Against the clean round from the same
    init and selection: the coalition's own updates are -2x theirs and
    every other row bit-equal; the other cluster's merge, and every
    state of its clients, bit-equal; the victim's merge the host's
    sign_flip of the host's f64 merge of the round's (poisoned) params
    (<= 1e-6 scale-normalized). Each engine runs the round once to
    capture its graphs, then again as a replay."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.redteam import RedteamSpec
    sel, voter, mate = _accomplices(cfg, n, assignment)
    victim = int(assignment[voter])
    spec = RedteamSpec(kind="cluster_poison", adversaries=(voter, mate),
                       victim_cluster=victim, poison="sign_flip",
                       strength=2.0, lie_votes=True)
    runs = {}
    for name, s in (("clean", None), ("red", spec)):
        with _merge_stash() as stash:
            eng = _red_engine(torch, cfg, data, n, init, assignment, s)
            eng.run_round_fused(0, selected=sel)  # its capture
            eng.reset_federation()
            res = eng.run_round_fused(0, selected=sel)
            _sync(torch, data.train_xb.device)
            runs[name] = (res, eng.states.clone(), stash["params"].cpu(),
                          stash["merges"].cpu())
    (red, red_st, red_p, red_m), (clean, clean_st, clean_p, clean_m) = \
        runs["red"], runs["clean"]
    if red.aggregator != mate:
        raise AssertionError(f"[redteam] (b) the accomplice {mate} was not "
                             f"elected: {red.aggregator}")
    coalition = torch.zeros(n, dtype=torch.bool)
    coalition[[voter, mate]] = True
    if not (torch.equal(red_p[:n][coalition], -2.0 * clean_p[:n][coalition])
            and torch.equal(red_p[:n][~coalition], clean_p[:n][~coalition])):
        raise AssertionError("[redteam] (b) the update stage touched more "
                             "than the coalition's rows")
    others = [c for c in range(REDTEAM_K) if c != victim]
    rows = torch.from_numpy(np.asarray(assignment) != victim)
    layout = ParamLayout(*DIMS)
    other_states = _state_errs(
        torch, layout, red_st.apply(lambda t: t.cpu()[: n][rows]),
        clean_st.apply(lambda t: t.cpu()[: n][rows]))
    if not torch.equal(red_m[others], clean_m[others]) \
            or max(other_states.values()) != 0:
        raise AssertionError(f"[redteam] (b) the other clusters' broadcast "
                             f"moved: {json.dumps(other_states)}")
    host = _host_merges(red, red_p, np.asarray(assignment), REDTEAM_K)
    err = scaled_err(red_m[victim], -spec.strength * host[victim])
    log(f"[redteam] (b) coalition ({voter}, {mate}) in cluster {victim}: "
        f"the accomplice elected; its cluster's merge the host's sign_flip "
        f"of the host's f64 merge (worst scaled error {err:.3e}, limit "
        f"1e-6); cluster(s) {others}' merge and clients bit-equal to the "
        f"clean round's")
    if err > 1e-6:
        raise AssertionError(f"[redteam] (b) victim merge: {err:.3e}")
    return {"coalition": [voter, mate], "victim": victim,
            "aggregator": red.aggregator,
            "clean_aggregator": clean.aggregator,
            "victim_merge_max_scaled_err": err,
            "other_clusters_bit_equal": True}, spec, sel


def redteam_knn_round(torch, cfg, data, n, init, assignment, spec):
    """(g) (b)'s red round kNN-scored (the distance launch in the leave
    graph): every metric finite."""
    eng = _red_engine(torch, cfg.replace(score_kind="knn", **KNN), data, n,
                      init, assignment, spec)
    res = eng.run_round_fused(0)
    if not np.isfinite(res.client_metrics).all():
        raise AssertionError(f"[redteam] (g) kNN metrics "
                             f"{res.client_metrics}")
    log(f"[redteam] (g) kNN-scored red round: aggregator {res.aggregator}, "
        f"mean AUC {np.mean(res.client_metrics):.6f}")
    return {"aggregator": res.aggregator,
            "mean_auc": float(np.mean(res.client_metrics))}


def redteam_null(torch, cfg, data, n, init, assignment):
    """(a) RedteamSpec() against no spec from one init over the quick run
    in one chunk, single-global and clustered (K = 2): states and every
    round's results bit-equal, the same graphs (nodes and kernels per
    replay). PR 10's records give the single-global graphs of this engine
    (autoencoder / mse_avg, 16 gateways) as enter 40, epoch 11,401, leave
    283 nodes."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.redteam import RedteamSpec
    out = {}
    for what, a in (("single_global", None), ("clustered", assignment)):
        engines = [_red_engine(torch, cfg, data, n, init, a, s)
                   for s in (None, RedteamSpec())]
        results = [e.run_rounds(0, cfg.num_rounds) for e in engines]
        _sync(torch, data.train_xb.device)
        errs = _state_errs(torch, ParamLayout(*DIMS), engines[1].states,
                           engines[0].states)
        same = max(errs.values()) == 0 and all(
            x.aggregator == y.aggregator
            and x.verification_results == y.verification_results
            and all(_same_bits(torch, getattr(x, f), getattr(y, f))
                    for f in ("client_metrics", "min_valid", "tracking"))
            for x, y in zip(*results))
        graphs = [e.fused_round().stats()["graphs"] for e in engines]
        shape = [{g: (s["nodes"], s["kernels_per_replay"])
                  for g, s in x.items()} for x in graphs]
        if not same or shape[0] != shape[1] \
                or engines[1].fused_round().redteam is not None:
            raise AssertionError(f"[redteam] (a) {what}: the null spec "
                                 f"differs from no spec: {json.dumps(errs)},"
                                 f" graphs {shape}")
        nodes = {g: s["nodes"] for g, s in graphs[0].items()}
        out[what] = {"bit_equal": True, "nodes": nodes,
                     "aggregators": [r.aggregator for r in results[0]]}
        log(f"[redteam] (a) {what}: RedteamSpec() bit-equal to no spec over "
            f"{cfg.num_rounds} rounds; graph nodes equal {nodes}")
    return out


def _replay_election(res, vote_ok, adv, count, assignment, thr, lie):
    """The election of `res`'s round on the host (tie-break off, so every
    voter ranks the winning voter's scores): (aggregator or None, the
    winning voter, whether it lied). A voter outside the effective cohort
    or gated casts no vote; a candidate is an effective selected client of
    the voter's cluster under the quota and ungated; a lying adversarial
    voter takes its earliest-selected adversarial candidate."""
    sel, eff = res.selected, set(res.effective)
    pos = {c: i for i, c in enumerate(sel)}
    for voter in sel:
        if voter not in eff or vote_ok[voter] <= 0:
            continue
        cand = [c for c in sel if c != voter and c in eff
                and count[c] < thr and vote_ok[c] > 0
                and assignment[c] == assignment[voter]]
        if not cand:
            continue
        if lie and adv[voter] > 0:
            acc = [c for c in cand if adv[c] > 0]
            if acc:
                return acc[0], voter, True
        if res.mse_scores is None:
            return "a candidate but no scores", voter, False
        s = res.mse_scores

        def rank(c):
            return (np.inf if np.isnan(s[c]) else float(s[c]), pos[c])
        return min(cand, key=rank), voter, False
    return None, None, False


def redteam_sybil(torch, cfg, data, n, init, assignment):
    """(c) sybil under a join blitz (half the slots open, join_p 0.9 from
    round 2) on the clustered round (K = 2), tie-break off: the coalition
    is every slot the blitz recycles, lie_votes on. Undefended, and with
    min_tenure longer than the run: every round's election is replayed
    on the host from the round's cohort, the gate and the host's quota,
    and must equal the device's; undefended, an accomplice must be elected
    by a lying voter at least once; defended, no gated slot is ever
    elected or the winning voter, and a gated slot must have been in an
    effective cohort."""
    import dataclasses as dc
    from fedmse_tpu_torch.federation.elastic import (ElasticSpec,
                                                     make_membership_masks)
    from fedmse_tpu_torch.redteam import RedteamSpec
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    p = REDTEAM_SYBIL
    c = cfg.replace(num_rounds=p["rounds"],
                    compat=dc.replace(cfg.compat, vote_tie_break=False))
    elastic = ElasticSpec(join_p=p["join_p"],
                          initial_member_frac=p["initial_member_frac"],
                          join_window=(p["join_start"], None))
    timeline = make_membership_masks(elastic, ExperimentRngs(
        run=0).elastic_key(), p["rounds"], n)
    adv_ids = tuple(int(i) for i in np.flatnonzero(
        timeline.generation.max(axis=0) > 0))
    if not adv_ids:
        raise AssertionError("[redteam] (c) the blitz recycled no slot")
    out = {"adversaries": list(adv_ids)}
    thr = c.max_aggregation_threshold
    for name, tenure in (("undefended", 0), ("min_tenure", p["min_tenure"])):
        spec = RedteamSpec(kind="sybil", adversaries=adv_ids, lie_votes=True,
                           min_tenure=tenure)
        eng = _red_engine(torch, c, data, n, init, assignment, spec,
                          elastic=elastic)
        results = eng.run_rounds(0, p["rounds"])
        masks = eng._redteam_masks(0, p["rounds"])
        count = np.zeros(n, np.int64)
        rows, lies, gated_seen = [], 0, 0
        for t, res in enumerate(results):
            want, voter, lied = _replay_election(
                res, masks.vote_ok[t], masks.adv[t], count, assignment, thr,
                True)
            if want != res.aggregator:
                raise AssertionError(f"[redteam] (c) {name} round {t + 1}: "
                                     f"the device elected {res.aggregator},"
                                     f" the host's replay {want}")
            gated = [i for i in res.effective if masks.vote_ok[t][i] <= 0]
            gated_seen += len(gated)
            if tenure and ((want is not None and masks.vote_ok[t][want] <= 0)
                           or (voter is not None
                               and masks.vote_ok[t][voter] <= 0)):
                raise AssertionError(f"[redteam] (c) a gated slot won round "
                                     f"{t + 1}")
            lies += lied
            if res.aggregator is not None:
                count[res.aggregator] += 1
            rows.append({"round": t + 1, "aggregator": res.aggregator,
                         "voter": voter, "lied": lied, "gated": gated,
                         "members": res.members})
        out[name] = {"rounds": rows, "lying_elections": lies,
                     "gated_in_cohort": gated_seen}
        log(f"[redteam] (c) sybil {name}: coalition {list(adv_ids)}; "
            f"rounds {json.dumps(rows)}; every election equal to the host's "
            f"replay")
    if out["undefended"]["lying_elections"] < 1:
        raise AssertionError("[redteam] (c) no accomplice was elected by a "
                             "lying voter: the collusion check held nothing")
    if out["min_tenure"]["gated_in_cohort"] < 1:
        raise AssertionError("[redteam] (c) no gated slot was in a cohort: "
                             "the gate check held nothing")
    return out


def redteam_card_vs_cpu(torch, device, cfg, data, cpu_data, n, init,
                        assignment, sel, spec):
    """(e) (b)'s red round as a noise poison (strength 0.05, the noise of
    the run's red-team stream), cut to one epoch, on the card and on the
    CPU from one init and selection: the same aggregator and verification
    rows, every state leaf within 1e-4 scale-normalized."""
    import dataclasses as dc
    from fedmse_tpu_torch.models.flat import ParamLayout
    noisy = dc.replace(spec, poison="noise", strength=0.05)
    c = cfg.replace(epochs=1)
    runs = []
    for where, d in ((device, data), (torch.device("cpu"), cpu_data)):
        eng = _red_engine(torch, c, d, n, init.to(where), assignment, noisy)
        runs.append((eng.run_round_fused(0, selected=sel), eng.states))
    (card_res, card), (cpu_res, cpu) = runs
    if (card_res.aggregator, card_res.verification_results) != (
            cpu_res.aggregator, cpu_res.verification_results):
        raise AssertionError(f"[redteam] (e) card vs CPU: aggregator "
                             f"{card_res.aggregator} vs {cpu_res.aggregator}")
    errs = _state_errs(torch, ParamLayout(*DIMS), card, cpu)
    err = max(errs[k] for k in ("params", "prev_global", "hist_params"))
    log(f"[redteam] (e) round 1 at one epoch with the noise poison, card vs "
        f"CPU: aggregator {card_res.aggregator}; worst scaled state error "
        f"{err:.3e} (limit 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"[redteam] (e) card vs CPU: {json.dumps(errs)}")
    return {"max_scaled_err": err, "errs": errs,
            "aggregator": card_res.aggregator}


def phase_redteam(torch, device, cfg):
    """The red team's round half on the typed fleet of phase_cluster (16
    gateways of 4 device types at 115/27/7) with the quick run's schedule,
    autoencoder / mse_avg, clustered at K = 2. (d) fits the assignment the
    other parts pin; (b) and (g) are the red path: every kernel's launch
    counter is set to 0 before them and read after, and each must have
    launched. The kernels at this fleet's shapes are held to their plain
    versions first (phase_cluster's cases: the red path launches them at
    the clustered path's shapes)."""
    from fedmse_tpu_torch.federation import init_client_states
    from fedmse_tpu_torch.models import make_model
    WRAPPERS = family_wrappers("autoencoder")
    t0 = time.perf_counter()
    data, cpu_data = cluster_fleet(cfg, (device, torch.device("cpu")))
    n = CLUSTER_FLEET["n_clients"]
    init = init_client_states(make_model("autoencoder", *DIMS,
                                         device=device), n,
                              torch.Generator().manual_seed(SEED + 13),
                              device=device)
    report = {"kernels": cluster_kernel_shapes(torch, device, data, n)}
    report["mimicry"], a = redteam_mimicry(torch, cfg, data, n, init)
    t1 = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    report["merge_poison"], spec, sel = redteam_merge_poison(
        torch, cfg, data, n, init, a)
    report["knn_round"] = redteam_knn_round(torch, cfg, data, n, init, a,
                                            spec)
    _sync(torch, device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[redteam] red path launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the red path never launched {name}")
    report["launches"] = launches
    report["red_path_seconds"] = time.perf_counter() - t1
    report["null"] = redteam_null(torch, cfg, data, n, init, a)
    report["sybil"] = redteam_sybil(torch, cfg, data, n, init, a)
    report["card_vs_cpu"] = redteam_card_vs_cpu(
        torch, device, cfg, data, cpu_data, n, init, a, sel, spec)
    report["seconds"] = time.perf_counter() - t0
    log(f"[redteam] done in {report['seconds']:.1f} s")
    return report


# ---- batched runs (phase "batch") ---- #

BATCH_RUNS = 3
BATCH_KERNEL_RUNS = (3, 8)  # the kernels at G = R·S of these R
BATCH_TIMED_RUNS = (3,)  # timed only; the record, not a claim
BATCH_TOL = 1e-5  # round 1 at one epoch, batched vs the runs alone


def batch_kernel_shapes(torch, device, data, n, cohort):
    """The kernels at the batched round's own shapes against their plain
    versions, f32 on dyadic grids: the train step at G = R·S (R = 3 and
    8) with one run's CTAs per client, each run's rows also the bits of
    that run's own G = S launch; the vote's forward over R·N routed models
    client-major, each run's rows the bits of its own N-model launch; the
    distances of a kNN evaluation over R·N banks. Returns the worst scaled
    errors."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    from fedmse_tpu_torch.ops.fused_train import (cluster_size,
                                                  fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 14)
    layout = ParamLayout(*DIMS)
    ctas = cluster_size(cohort, DIMS[1])
    kw = dict(layout=layout, shrink_lambda=10.0)
    worst = {}
    for runs in BATCH_KERNEL_RUNS:
        g = runs * cohort
        flat, xt = grid_inputs(torch, layout, g, 12, gen, device)
        m = torch.ones((g, 12), device=device)
        got = fused_train_grads(flat, xt, m, ctas=ctas, **kw)
        err = max(scaled_err(a, b) for a, b in zip(
            got, fused_train_grads_plain(flat, xt, m, **kw)))
        if err > TOL["f32"]:
            raise AssertionError(f"[batch] train kernel vs plain at G={g}: "
                                 f"{err:.3e}")
        for r in range(runs):
            rows = slice(r * cohort, (r + 1) * cohort)
            alone = fused_train_grads(flat[rows], xt[rows], m[rows], **kw)
            if not all(torch.equal(a[rows], b) for a, b in zip(got, alone)):
                raise AssertionError(f"[batch] run {r}'s rows of the G={g} "
                                     "train launch differ from its own")
        worst[f"train step, G = {g}"] = err
    v = data.valid_x.shape[1]
    runs = BATCH_RUNS
    params = grid_params(torch, runs * n, *DIMS, gen, device, torch.float32)
    x = (torch.randint(-6, 7, (runs * n * v, DIMS[0]), generator=gen) / 4.0
         ).to(device)
    idx = forward_index(torch, "client_major", runs * n, runs * n * v, gen,
                        device)
    got = fused_forward_stats(params, x, idx)
    worst["vote, R·N models"] = max(scaled_err(a, b) for a, b in zip(
        got, fused_forward_stats_plain(params, x, idx)))
    if worst["vote, R·N models"] > TOL["f32"]:
        raise AssertionError(f"[batch] forward kernel vs plain: "
                             f"{worst['vote, R·N models']:.3e}")
    for r in range(runs):
        rows = slice(r * n * v, (r + 1) * n * v)
        mine = {c: {k: {leaf: t[r * n:(r + 1) * n] for leaf, t in
                        layer.items()} for k, layer in coder.items()}
                for c, coder in params.items()}
        alone = fused_forward_stats(mine, x[rows],
                                    idx[rows] - r * n)
        if not all(torch.equal(a[rows], b) for a, b in zip(got, alone)):
            raise AssertionError(f"[batch] run {r}'s routed rows differ "
                                 "from its own launch's bits")
    q, banks, gw = dist_inputs(torch, runs * n, runs * n * data.test_x.shape[1],
                               KNN["knn_bank_size"], DIMS[2], "client_major",
                               gen, device, torch.float32)
    _, _, worst["distances, kNN evaluation"] = dist_check(
        torch, q, banks, gw, f"[batch] kNN evaluation, {runs * n} banks")
    log(f"[batch] kernels at the batched round's shapes agree with their "
        f"plain versions, each run's rows its own launch's bits: "
        f"{json.dumps(worst)}")
    return worst


def _early(cfg):
    from fedmse_tpu_torch.main import GlobalEarlyStop
    return GlobalEarlyStop(inverted=cfg.compat.inverted_global_early_stop,
                           patience=cfg.global_patience)


def batch_vs_sequential(torch, cfg, data, n, model_type="hybrid",
                        update_type="mse_avg"):
    """run_batched_combination of R = 3 seeds against R run_combination
    calls (each its own early stop) on the card, from the runs' own
    inits: per run the same selections, aggregators and stop round, final
    AUC within 2e-3 per gateway, and each state's worst scaled error
    (bit-equal when 0). The batched launches are read around the batched
    run and a kNN-scored batched chunk; the epoch graph must hold one train
    launch per step for all runs (as one run's graph does)."""
    from fedmse_tpu_torch.main import (run_batched_combination,
                                       run_combination)
    from fedmse_tpu_torch.models.flat import ParamLayout
    WRAPPERS = family_wrappers("autoencoder")
    c = cfg.replace(num_runs=BATCH_RUNS)
    seq = [run_combination(c, data, n, model_type, update_type, r,
                           early_stop=_early(c)) for r in range(BATCH_RUNS)]
    _sync(torch, data.train_xb.device)
    for w in WRAPPERS.values():
        w.launches = 0
    bat = run_batched_combination(c, data, n, model_type, update_type)
    engine = bat[0]["engine"]
    _sync(torch, data.train_xb.device)
    knn = run_batched_combination(c.replace(score_kind="knn", num_rounds=1,
                                            **KNN),
                                  data, n, model_type, update_type)
    _sync(torch, data.train_xb.device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the batched path never launched {name}")
    if not all(np.isfinite(o["final_metrics"]).all() for o in knn):
        raise AssertionError("[batch] kNN-scored batched metrics not finite")
    layout = ParamLayout(*DIMS)
    rows, worst_state, worst_auc = [], 0.0, 0.0
    for r, (s, b) in enumerate(zip(seq, bat)):
        same = (s["rounds_run"] == b["rounds_run"] and all(
            x.aggregator == y.aggregator and x.selected == y.selected
            for x, y in zip(s["rounds"], b["rounds"])))
        if not same:
            raise AssertionError(
                f"[batch] run {r}: batched aggregators "
                f"{[x.aggregator for x in b['rounds']]} in "
                f"{b['rounds_run']} rounds, alone "
                f"{[x.aggregator for x in s['rounds']]} in "
                f"{s['rounds_run']}")
        errs = _state_errs(torch, layout, engine.states.apply(
            lambda t, r=r: t.chunk(BATCH_RUNS)[r]), s["engine"].states)
        auc = float(np.abs(np.asarray(b["final_metrics"])
                           - np.asarray(s["final_metrics"])).max())
        worst_state = max(worst_state, max(errs.values()))
        worst_auc = max(worst_auc, auc)
        rows.append({"run": r, "rounds_run": b["rounds_run"],
                     "aggregators": [x.aggregator for x in b["rounds"]],
                     "final_auc_max_abs_diff": auc,
                     "state_max_scaled_err": max(errs.values()),
                     "differing": {k: v for k, v in errs.items() if v}})
    graphs = engine.fused_round().stats()["graphs"]
    nb = data.train_xb.shape[1]
    per_step = graphs["epoch"]["kernels_per_replay"].get("fused_ae_train")
    alone = seq[0]["engine"].fused_round().stats()["graphs"]["epoch"][
        "kernels_per_replay"].get("fused_ae_train")
    if data.train_xb.is_cuda and (per_step != nb or alone != nb):
        raise AssertionError(f"[batch] the epoch graph holds {per_step} "
                             f"train launches for {nb} steps of 3 runs "
                             f"({alone} for one run's)")
    log(f"[batch] R = {BATCH_RUNS} batched vs alone: "
        f"{json.dumps(rows)}; final AUC within {worst_auc:.3e} (limit "
        f"2e-3), states within {worst_state:.3e} scale-normalized "
        f"(bit-equal: {worst_state == 0}); the epoch graph {nb} train "
        f"launches a replay for all runs; batched path launches "
        f"{json.dumps(launches)}")
    if worst_auc > 2e-3:
        raise AssertionError(f"[batch] final AUC {worst_auc:.3e} > 2e-3")
    return {"runs": rows, "final_auc_max_abs_diff": worst_auc,
            "state_max_scaled_err": worst_state,
            "bit_equal": worst_state == 0, "launches": launches,
            "train_launches_per_step": per_step,
            "graphs": graphs}


def batch_one_epoch(torch, cfg, data, n):
    """Round 1 cut to one epoch, batched R = 3 against the runs alone from
    the same inits and selections: the same aggregators and every state
    leaf within BATCH_TOL scale-normalized (the summation order of a
    reduction on the card depends on how many rows it reduces; the train
    kernel runs one run's CTAs per client, its bits the run's own)."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.batched import BatchedRunEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(epochs=1, num_runs=BATCH_RUNS)
    dev = data.train_xb.device
    model = make_model("hybrid", *DIMS, device=dev)
    bat = BatchedRunEngine(model, c, data, n, BATCH_RUNS, "hybrid",
                           "mse_avg")
    outs, sched, _ = bat.run_schedule_chunk(0, 1, np.ones(BATCH_RUNS, bool))
    worst, layout, differing = 0.0, ParamLayout(*DIMS), {}
    for r in range(BATCH_RUNS):
        eng = RoundEngine(model, c, data, n, ExperimentRngs(run=r),
                          "hybrid", "mse_avg", fused=True)
        res = eng.run_rounds(0, 1)[0]
        got = bat.process_round(r, 0, sched[0][r], outs, 0)
        if (got.aggregator, got.selected) != (res.aggregator, res.selected):
            raise AssertionError(f"[batch] one epoch, run {r}: aggregator "
                                 f"{got.aggregator} vs {res.aggregator}")
        errs = _state_errs(torch, layout, bat.states.apply(
            lambda t, r=r: t.chunk(BATCH_RUNS)[r]), eng.states)
        worst = max(worst, max(errs.values()))
        differing.update({f"run{r}/{k}": v for k, v in errs.items() if v})
    log(f"[batch] round 1 at one epoch, batched vs alone: worst scaled "
        f"state error {worst:.3e} (limit {BATCH_TOL:g}; bit-equal: "
        f"{worst == 0}; differing {json.dumps(differing)})")
    if worst > BATCH_TOL:
        raise AssertionError(f"[batch] one epoch: {worst:.3e}")
    return worst


def _busy_ms(torch, fn) -> float:
    """Device milliseconds of fn()'s CUDA kernels and copies
    (torch.profiler, CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()) / 1e3


def batch_round_times(torch, cfg, data, n, smi):
    """The steady round (graphs captured) of R = 3 runs batched against
    the same R runs alone, one after another: host wall per
    round of all R runs (the quick run's rounds in one chunk, no early
    stop, each engine reset to its init first), each kernel's launches
    per round, and for R = 3 round 1's device time (torch.profiler). A
    record, not a claim."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.batched import BatchedRunEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.ops.graphs import WRAPPERS
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    dev = data.train_xb.device
    model = make_model("hybrid", *DIMS, device=dev)
    k = cfg.num_rounds
    out = {"device": smi}

    def timed(fn):
        fn()  # the capture, untimed
        for w in WRAPPERS.values():
            w.launches = 0
        _sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        _sync(torch, dev)
        return ((time.perf_counter() - t0) * 1e3 / k,
                {name: w.launches / k for name, w in WRAPPERS.items()})

    for runs in BATCH_TIMED_RUNS:
        c = cfg.replace(num_runs=runs)
        bat = BatchedRunEngine(model, c, data, n, runs, "hybrid", "mse_avg")
        alone = [RoundEngine(model, c, data, n, ExperimentRngs(run=r),
                             "hybrid", "mse_avg", fused=True)
                 for r in range(runs)]

        def batched():
            bat.reset_federation()
            bat.run_schedule_chunk(0, k, np.ones(runs, bool))

        def sequential():
            for e in alone:
                e.reset_federation()
                e.run_rounds(0, k)
        row = {}
        for name, fn in (("batched", batched), ("sequential", sequential),
                         ("batched_again", batched)):
            wall, launches = timed(fn)
            row[name] = {"round_wall_ms": wall, "launches_per_round":
                         launches}
        if runs == BATCH_RUNS and dev.type == "cuda":
            # round 1 alone under the profiler (CUDA activity only: a whole
            # chunk of R runs one after another is ~10^6 kernel records,
            # and a flood of them cost later profiler windows their events)
            def one_round(engines):
                for e in engines:
                    e.reset_federation()
                    if e is bat:
                        e.run_schedule_chunk(0, 1, np.ones(runs, bool))
                    else:
                        e.run_rounds(0, 1)
            for name, engines in (("batched", [bat]), ("sequential", alone)):
                row[name]["device_ms_round_1"] = _busy_ms(
                    torch, lambda: one_round(engines))
        out[f"R={runs}"] = row
        log(f"[batch] R = {runs}, hybrid/mse_avg quick run, steady round of "
            f"all {runs} runs ({smi}): batched "
            f"{row['batched']['round_wall_ms']:.3f} / "
            f"{row['batched_again']['round_wall_ms']:.3f} ms (round 1 on "
            f"the device {row['batched'].get('device_ms_round_1')} ms), the "
            f"runs one after another {row['sequential']['round_wall_ms']:.3f}"
            f" ms ({row['sequential'].get('device_ms_round_1')} ms); "
            f"launches per round batched "
            f"{json.dumps(row['batched']['launches_per_round'])}, one after "
            f"another {json.dumps(row['sequential']['launches_per_round'])}")
    return out


def phase_batch(torch, device, cfg, clients, data, smi):
    """Batched runs (--batch-runs) on the quick run's 10 gateways at
    115/27/7, hybrid / mse_avg: the kernels at the batched shapes, R = 3
    batched against the runs alone through the drivers (the batched path:
    launch counters set to 0 before it and read after), round 1 at one
    epoch to BATCH_TOL, then the steady round of R = 3 timed."""
    t0 = time.perf_counter()
    n = len(clients)
    cohort = max(1, int(cfg.num_participants * n))
    report = {"kernels": batch_kernel_shapes(torch, device, data, n, cohort)}
    report["vs_alone"] = batch_vs_sequential(torch, cfg, data, n)
    report["one_epoch_max_scaled_err"] = batch_one_epoch(torch, cfg, data, n)
    report["round_times"] = batch_round_times(torch, cfg, data, n, smi)
    report["launches"] = report["vs_alone"]["launches"]
    report["seconds"] = time.perf_counter() - t0
    log(f"[batch] done in {report['seconds']:.1f} s")
    return report


# ---- the tiered state layout (phase "tiered") ---- #

TIERED_FLEETS = (100_000, 10_000)  # N of the full-size runs, (c)
TIERED_COHORT = 512                # C
TIERED_TIMED_ROUNDS = 3            # after one warm round (the capture)
TIERED_PEAK_TOL = 0.05             # (c): peak device bytes, N vs N
# (f): the --podscale drivers' widths and epochs (cluster_sweep_torch
# podscale_config), 2 rounds at full participation
TIERED_KEYED_DIMS = (8, 6, 3)
TIERED_KEYED_ROUNDS = 2
# (g): the dense fused engine at the largest N, full participation, at
# (f)'s widths: one warm round, then TIERED_DENSE_TIMED_ROUNDS timed, the
# tie-break on (keyed) and off, peak device bytes within
# TIERED_DENSE_PEAK_TOL; then R = TIERED_BATCH_RUNS batched keyed runs at
# TIERED_BATCH_N gateways against each run alone
TIERED_DENSE_TIMED_ROUNDS = 2
TIERED_DENSE_PEAK_TOL = 0.01
TIERED_BATCH_N = 10_000
TIERED_BATCH_RUNS = 3


def bulk_federation(torch, n, dim, batch, seed):
    """bench.py:1267's host federation as CPU tensors drawn in bulk from a
    seeded generator: one train batch, 4 validation rows, 8 normal and 8
    abnormal test rows per client, a 256-row dev set."""
    from fedmse_tpu_torch.data.stacking import FederatedData
    g = torch.Generator().manual_seed(seed)
    v, half = 4, 8
    valid = torch.randn((n, v, dim), generator=g)
    valid_xb = torch.zeros((n, 1, batch, dim))
    valid_xb[:, 0, :v] = valid
    valid_mb = torch.zeros((n, 1, batch))
    valid_mb[:, 0, :v] = 1.0
    test = torch.cat([torch.randn((n, half, dim), generator=g),
                      torch.randn((n, half, dim), generator=g) * 1.5 + 3.0],
                     dim=1)
    return FederatedData(
        train_xb=torch.randn((n, 1, batch, dim), generator=g),
        train_mb=torch.ones((n, 1, batch)), valid_xb=valid_xb,
        valid_mb=valid_mb, valid_x=valid, valid_m=torch.ones((n, v)),
        test_x=test, test_m=torch.ones((n, 2 * half)),
        test_y=torch.cat([torch.zeros((n, half)), torch.ones((n, half))],
                         dim=1),
        dev_x=torch.randn((256, dim), generator=g),
        client_mask=torch.ones(n))


def _federation_rows(data, n, device=None):
    """Clients [0, n) of a FederatedData (views), on `device` if given."""
    import dataclasses
    from fedmse_tpu_torch.data.stacking import FederatedData
    return FederatedData(**{
        f.name: (lambda t: t if device is None else t.to(device))(
            getattr(data, f.name) if f.name == "dev_x"
            else getattr(data, f.name)[:n])
        for f in dataclasses.fields(FederatedData)})


TIERED_LAUNCHES = {}  # the tiered engines' kernel launches, by wrapper


@contextlib.contextmanager
def tiered_path():
    """Count the kernel launches of the tiered engines' work inside: every
    count set to 0 just before and read just after, into
    TIERED_LAUNCHES (the dense engines they are held to run outside)."""
    with counted_launches(TIERED_LAUNCHES):
        yield


def _tiered(torch, cfg, data, n, device, **kw):
    from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    return TieredRoundEngine(make_model("hybrid", *DIMS, device=device), cfg,
                             data, n, ExperimentRngs(run=0), "hybrid",
                             "mse_avg", device=device, **kw)


def _tiered_rounds(engine, k):
    out, secs = [], []
    engine.run_rounds(0, k, lambda r, s: out.append(r) or secs.append(s)
                      or False)
    return out, secs


def _same_results(torch, got, want, what):
    """Two RoundResult lists equal bit for bit (NaN where NaN)."""
    for i, (a, b) in enumerate(zip(got, want)):
        for f in ("selected", "aggregator", "verification_results"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"[tiered] {what}, round {i}: {f} "
                                     f"{getattr(a, f)} vs {getattr(b, f)}")
        for f in ("client_metrics", "mse_scores", "agg_weights",
                  "tracking", "min_valid"):
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None) or (
                    x is not None and not _same_bits(torch, x, y)):
                raise AssertionError(f"[tiered] {what}, round {i}: {f} "
                                     "differs")


def _same_states(torch, a, b, what):
    for name, x, y in zip(("params", "count", "mu", "nu", "prev_global",
                           "hist_params", "hist_perf", "hist_seen",
                           "rejected", "waived"), a.tensors(), b.tensors()):
        if not _same_bits(torch, x.cpu(), y.cpu()):
            raise AssertionError(f"[tiered] {what}: {name} differs")


def tiered_kernel_shapes(torch, device, cohort):
    """The kernels at the tiered round's shapes against their plain
    versions, f32 on dyadic grids, each also bit-equal to a second call:
    the train step at G = C (12 rows a client, 1 CTA per client), and the
    forward over C routed models client-major at the round's evaluation
    (C x (16 test + 12 train) rows), its vote (C x 4 rows) and its
    streamed final evaluation's chunk. Returns the worst scaled errors."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    from fedmse_tpu_torch.ops.fused_train import (cluster_size,
                                                  fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 21)
    layout = ParamLayout(*DIMS)
    kw = dict(layout=layout, shrink_lambda=10.0)
    flat, xt = grid_inputs(torch, layout, cohort, 12, gen, device)
    m = torch.ones((cohort, 12), device=device)
    got = fused_train_grads(flat, xt, m, **kw)
    again = fused_train_grads(flat, xt, m, **kw)
    worst = {f"train step, G = {cohort}": max(scaled_err(a, b) for a, b in zip(
        got, fused_train_grads_plain(flat, xt, m, **kw)))}
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("[tiered] train launch not bit-equal to a "
                             "second call")
    params = grid_params(torch, cohort, *DIMS, gen, device, torch.float32)
    for what, per in (("evaluation", 28), ("vote", 4)):
        rows = cohort * per
        x = (torch.randint(-6, 7, (rows, DIMS[0]), generator=gen) / 4.0
             ).to(device)
        idx = forward_index(torch, "client_major", cohort, rows, gen, device)
        got = fused_forward_stats(params, x, idx)
        again = fused_forward_stats(params, x, idx)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"[tiered] {what} forward not bit-equal to "
                                 "a second call")
        worst[f"{what}, {cohort} routed models"] = max(
            scaled_err(a, b) for a, b in zip(
                got, fused_forward_stats_plain(params, x, idx)))
    bad = {k: v for k, v in worst.items() if v > TOL["f32"]}
    if bad:
        raise AssertionError(f"[tiered] kernels vs plain: {bad}")
    log(f"[tiered] kernels at the tiered round's shapes (cluster size "
        f"{cluster_size(cohort, DIMS[1])} at G = {cohort}) agree with their "
        f"plain versions and with a second call: {json.dumps(worst)}")
    return worst


def tiered_vs_dense(torch, device, cfg, data, n):
    """(a) The quick run at num_participants = 1.0 (C == N), 3 rounds,
    hybrid / mse_avg: the tiered engine against the dense fused engine,
    results, states and the final evaluation bit for bit."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = cfg.replace(num_participants=1.0)
    dense = RoundEngine(make_model("hybrid", *DIMS, device=device), c, data,
                        n, ExperimentRngs(run=0), "hybrid", "mse_avg",
                        fused=True)
    want = dense.run_rounds(0, c.num_rounds)
    with tiered_path():
        tier = _tiered(torch, c, data, n, device)
        got, _ = _tiered_rounds(tier, c.num_rounds)
        final = tier.evaluate_final_streamed()
    _same_results(torch, got, want, "C == N vs dense")
    _same_states(torch, tier.store.host, dense.states, "C == N vs dense")
    if not _same_bits(torch, final, dense.evaluate()):
        raise AssertionError("[tiered] C == N: final evaluation differs")
    graphs = {"tiered": tier._round.stats()["graphs"],
              "dense": dense.fused_round().stats()["graphs"]}
    nodes = {k: {b: g[b]["nodes"] for b in g} for k, g in graphs.items()}
    log(f"[tiered] (a) C == N = {n}: {c.num_rounds} rounds, states, results "
        f"and the final evaluation bit-equal to the dense fused engine; "
        f"aggregators {[r.aggregator for r in got]}; graph nodes "
        f"{json.dumps(nodes)}")
    return {"bit_equal": True, "aggregators": [r.aggregator for r in got],
            "nodes": nodes}


def tiered_partial(torch, device, cfg, data, n):
    """(b) The quick run at 0.5: the prefetched loop against the serial
    run_round loop bit for bit; round 0's cohort rows' tracking and
    min_valid the dense engine's; every non-cohort round metric NaN."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    k = cfg.num_rounds
    with tiered_path():
        serial = _tiered(torch, cfg, data, n, device)
        want = [serial.run_round(r) for r in range(k)]
        pre = _tiered(torch, cfg, data, n, device)
        got, _ = _tiered_rounds(pre, k)
    _same_results(torch, got, want, "prefetched vs serial")
    _same_states(torch, pre.store.host, serial.store.host,
                 "prefetched vs serial")
    dense = RoundEngine(make_model("hybrid", *DIMS, device=device), cfg,
                        data, n, ExperimentRngs(run=0), "hybrid", "mse_avg",
                        fused=True)
    first = dense.run_round_fused(0)
    sel = np.asarray(got[0].selected)
    if first.selected != got[0].selected or not (
            _same_bits(torch, got[0].tracking[sel], first.tracking[sel])
            and _same_bits(torch, got[0].min_valid[sel],
                           first.min_valid[sel])):
        raise AssertionError("[tiered] (b) round 0's cohort curves differ "
                             "from the dense engine's")
    for r in got:
        off = np.setdiff1d(np.arange(n), r.selected)
        if not (np.isnan(r.client_metrics[off]).all()
                and np.isfinite(r.client_metrics[r.selected]).all()):
            raise AssertionError(f"[tiered] (b) round {r.round_index}: "
                                 "cohort metrics not finite or others not "
                                 "NaN")
    overlaps = sum(len(set(a.selected) & set(b.selected))
                   for a, b in zip(got, got[1:]))
    summary = pre.stats.summary()
    log(f"[tiered] (b) C = {pre.cohort} of {n}: the prefetched loop bit-equal "
        f"to the serial loop over {k} rounds ({overlaps} rows patched from "
        f"the previous round's output), round 0's cohort curves the dense "
        f"engine's bits, non-cohort metrics NaN; prefetch {json.dumps(summary)}")
    return {"bit_equal": True, "patched_rows": overlaps,
            "stats": summary}


def _host_memory() -> dict:
    import resource
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return {"peak_rss_bytes": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024, "mem_available_bytes": avail}


def _clear_card(torch, device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)
    return 0


def tiered_full_size(torch, device, cfg, bulk, n, smi):
    """(c) N bulk gateways at 115/27/7, C = TIERED_COHORT, hybrid /
    mse_avg: a warm round (the capture), then TIERED_TIMED_ROUNDS timed
    rounds of the prefetched loop; the tier's init, the host and device
    bytes, the prefetch telemetry, the round's device time (one more
    serial round under the profiler), the H2D of one staging slab, and at
    the smaller N the streamed final evaluation."""
    c = TIERED_COHORT
    tc = cfg.replace(num_participants=(c + 0.5) / n,
                     num_rounds=1 + TIERED_TIMED_ROUNDS)
    data = _federation_rows(bulk, n)
    base = _clear_card(torch, device)
    with tiered_path():
        t0 = time.perf_counter()
        eng = _tiered(torch, tc, data, n, device)
        init_s = time.perf_counter() - t0
        if eng.cohort != c:
            raise AssertionError(f"[tiered] cohort {eng.cohort}, expected "
                                 f"{c}")
        steps = _host_seconds(eng)
        res, secs = _tiered_rounds(eng, tc.num_rounds)
    host = {k: float(np.mean(v[1:])) for k, v in steps.items()}
    out = {"n": n, "cohort": c, "device": smi, "init_s": init_s,
           "host_state_bytes": eng.store.host_bytes(),
           "host_data_bytes": sum(t.numel() * t.element_size()
                                  for t in eng.host_data.values()),
           "warm_round_s": secs[0], "timed_round_s": secs[1:],
           "sec_per_round": float(np.mean(secs[1:])),
           "prefetch_gap_s": list(eng.stats.prefetch_wait_s),
           "prefetch_issue_s": list(eng.stats.prefetch_issue_s),
           "overlapped_issue": list(eng.stats.overlapped_issue),
           "overlapped": eng.stats.summary()["overlapped"],
           "main_thread_s": host,
           "cohort_bytes": eng.cohort_bytes(),
           "aggregators": [r.aggregator for r in res]}
    for r in res:
        off = np.ones(n, bool)
        off[r.selected] = False
        if not (np.isfinite(r.client_metrics[r.selected]).all()
                and np.isnan(r.client_metrics[off]).all()):
            raise AssertionError(f"[tiered] (c) N = {n}, round "
                                 f"{r.round_index}: cohort metrics not "
                                 "finite or others not NaN")
    if not all(torch.isfinite(t).all() for t in
               (eng.store.host.params, eng.store.host.opt_state.nu)):
        raise AssertionError(f"[tiered] (c) N = {n}: the tier is not finite")
    if device.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device) \
            - base
        stage = eng._staging[0]
        out["h2d_slab_ms"] = cuda_ms(lambda: [
            d.copy_(s, non_blocking=True) for d, s in
            zip(eng._dslab.tensors(), stage.tensors())], 5)
        out["h2d_slab_bytes"] = sum(t.numel() * t.element_size()
                                    for t in stage.tensors())
        k = tc.num_rounds
        with tiered_path():
            out["round_device_ms"] = _busy_ms(torch,
                                              lambda: eng.run_round(k))
    if n == min(TIERED_FLEETS):
        with tiered_path():
            t1 = time.perf_counter()
            final = eng.evaluate_final_streamed()
            out["final_eval_s"] = time.perf_counter() - t1
        if final.shape != (n,) or not np.isfinite(final).all():
            raise AssertionError("[tiered] (c) streamed final evaluation "
                                 "not finite")
    out.update(_host_memory())
    log(f"[tiered] (c) N = {n}, C = {c} ({smi}): tier init "
        f"{init_s:.3f} s, host {out['host_state_bytes']} B state + "
        f"{out['host_data_bytes']} B data; warm round {secs[0]:.4f} s, "
        f"timed {json.dumps(out['timed_round_s'])} s/round; prefetch gap "
        f"{json.dumps(out['prefetch_gap_s'])} s, issue "
        f"{json.dumps(out['prefetch_issue_s'])} s, overlapped "
        f"{out['overlapped']}; the main thread's seconds per timed round "
        f"{json.dumps(host)}; peak device "
        f"{out.get('peak_device_bytes')} B beside cohort_bytes "
        f"{json.dumps(out['cohort_bytes'])}; one slab's H2D "
        f"{out.get('h2d_slab_ms')} ms ({out.get('h2d_slab_bytes')} B), a "
        f"round on the device {out.get('round_device_ms')} ms; host peak "
        f"RSS {out['peak_rss_bytes']} B, MemAvailable "
        f"{out['mem_available_bytes']} B")
    del eng
    return out


def _host_seconds(engine) -> dict:
    """Wrap the engine's main-thread steps to record each call's host
    seconds, by step: the round's entry copies (`_load`), the dispatch
    (the epochs' host reads wait on the card), the wait for the output's
    D2H and its scatter into the tier (`_scatter_out`) and the bookkeeping
    (`_absorb`)."""
    seconds = {"load": [], "dispatch": [], "scatter": [], "absorb": []}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            seconds[name].append(time.perf_counter() - t0)
            return out
        return call
    for name, attr in (("load", "_load"), ("dispatch", "_dispatch"),
                       ("scatter", "_scatter_out"), ("absorb", "_absorb")):
        setattr(engine, attr, timed(name, getattr(engine, attr)))
    return seconds


def tiered_dense_at_scale(torch, device, cfg, bulk, n, smi):
    """(d) The dense fused engine at the same N and C, recorded with no
    limit: a warm round, then TIERED_TIMED_ROUNDS rounds in one chunk
    (sec/round) and the peak device bytes. The vote tie-break is on, and
    its [C, N] sheet is above the size rule: the rounds are keyed."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    c = TIERED_COHORT
    tc = cfg.replace(num_participants=(c + 0.5) / n,
                     num_rounds=1 + TIERED_TIMED_ROUNDS)
    base = _clear_card(torch, device)
    data = _federation_rows(bulk, n, device)
    t0 = time.perf_counter()
    eng = RoundEngine(make_model("hybrid", *DIMS, device=device), tc, data,
                      n, ExperimentRngs(run=0), "hybrid", "mse_avg",
                      fused=True)
    init_s = time.perf_counter() - t0
    eng.run_rounds(0, 1)
    _sync(torch, device)
    t1 = time.perf_counter()
    res = eng.run_rounds(1, TIERED_TIMED_ROUNDS)
    _sync(torch, device)
    sec = (time.perf_counter() - t1) / TIERED_TIMED_ROUNDS
    if not all(np.isfinite(r.client_metrics).all() for r in res):
        raise AssertionError("[tiered] (d) dense metrics not finite")
    out = {"n": n, "cohort": c, "device": smi, "init_s": init_s,
           "sec_per_round": sec, "keyed": eng.keyed_tie_break,
           "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                 - base) if device.type == "cuda" else None}
    log(f"[tiered] (d) dense fused engine at N = {n}, C = {c} ({smi}), "
        f"tie-break keyed {out['keyed']}: "
        f"init {init_s:.3f} s, {sec:.4f} s/round over "
        f"{TIERED_TIMED_ROUNDS} rounds in one chunk, peak device "
        f"{out['peak_device_bytes']} B")
    del eng, data
    _clear_card(torch, device)
    return out


def _keyed_run(torch, device, tc, bulk, n, before):
    """One (f) run (module docstring of tiered_keyed_tie_break): its
    record, and with the tie-break on its checks. Everything it builds
    dies at its return, so the next run's peak bytes start clean."""
    from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
    from fedmse_tpu_torch.federation.voting import KeyedDraws
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    class Spied(TieredRoundEngine):
        """Records whether each plan drew a tie-break sheet."""

        def _plan(self, *a, **k):
            plan = super()._plan(*a, **k)
            self.plan_sheets.append(plan.draws is not None)
            return plan

    tie = tc.compat.vote_tie_break
    dim, hid, lat = TIERED_KEYED_DIMS
    base = _clear_card(torch, device)
    with tiered_path():
        eng = Spied(make_model("hybrid", dim, hid, lat, tc.shrink_lambda,
                               device=device), tc, bulk, n,
                    ExperimentRngs(run=0), "hybrid", "mse_avg",
                    device=device)
        eng.plan_sheets = []
        init_gen = eng.rngs.generator.get_state()
        res, secs = _tiered_rounds(eng, tc.num_rounds)
    run = {"keyed": eng.keyed_tie_break,
           "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                 - base) if device.type == "cuda" else None,
           "round_s": secs, "aggregators": [r.aggregator for r in res]}
    for r in res:
        if not np.isfinite(r.client_metrics).all():
            raise AssertionError(f"[tiered] (f) tie-break {tie}: round "
                                 f"{r.round_index} metrics not finite")
    if not tie:
        return run
    run["launches"] = {k: v - before.get(k, 0)
                       for k, v in TIERED_LAUNCHES.items()}
    for name in ("fused_ae_forward", "fused_ae_train"):
        if run["launches"].get(name, 0) < 1:
            raise AssertionError(f"[tiered] (f) the keyed run never "
                                 f"launched {name}")
    f = eng._round
    sheet = _round_sheets(torch, f, n, n)
    if not (eng.keyed_tie_break and f.u is None and f.u_all is None
            and not sheet and not any(eng.plan_sheets)
            and torch.equal(eng.rngs.generator.get_state(), init_gen)):
        raise AssertionError(f"[tiered] (f) the keyed path was not taken: "
                             f"sheets {sheet}, plan sheets "
                             f"{eng.plan_sheets}")
    run["row_bits_equal"] = _keyed_row_bits(torch, f, eng.rngs.vote_key(),
                                            n, device)
    if not run["row_bits_equal"]:
        raise AssertionError("[tiered] (f) the keyed row on the card "
                             "differs from the CPU's")
    if device.type == "cuda":
        src = KeyedDraws(f.tie_key["vote"], f.round_t, f.lane_ids)
        first = torch.zeros(1, dtype=torch.int64, device=device)
        run["hash_ms"] = cuda_ms(lambda: src.rows(first), 50)
        # as a node stretch of the captured `leave` graph runs it
        run["hash_graph_ms"] = graph_ms(torch, lambda: src.rows(first),
                                        device, 50)
    return run


def tiered_keyed_tie_break(torch, device, cfg, n, smi):
    """(f) The --podscale drivers' federation at N = n (8/6/3, batch 16,
    2 epochs, full participation: S = C = n), TIERED_KEYED_ROUNDS rounds
    with the vote tie-break on (above the tier's size rule: keyed rows)
    and then off: the keyed path taken (no plan drew a sheet, no [S, C]
    buffer in the round, the generator untouched by tie-breaks), the
    peak device bytes of the two runs within TIERED_PEAK_TOL, the keyed
    row of the round's own buffers on the card bit-equal to the CPU's
    and the numpy twin's for the same (key, round, voter, ids), and the
    one [N] hash an election computes, timed on the card."""
    from fedmse_tpu_torch.federation.tiered import keyed_tie_break
    dim, hid, lat = TIERED_KEYED_DIMS
    kc = _keyed_config(cfg, n, True, num_rounds=TIERED_KEYED_ROUNDS,
                       state_layout="tiered")
    if not keyed_tie_break(kc, n):
        raise AssertionError(f"[tiered] (f) N = {n} is under the size rule")
    bulk = bulk_federation(torch, n, dim, kc.batch_size, SEED + 22)
    out = {"n": n, "cohort": n, "dims": list(TIERED_KEYED_DIMS),
           "rounds": TIERED_KEYED_ROUNDS, "device": smi}
    before = dict(TIERED_LAUNCHES)
    for tie in (True, False):
        tc = _keyed_config(cfg, n, tie, num_rounds=TIERED_KEYED_ROUNDS,
                           state_layout="tiered")
        held = _clear_card(torch, device)
        run = _keyed_run(torch, device, tc, bulk, n, before)
        # bytes the run left allocated once it was freed (0 expected)
        run["residue_bytes"] = _clear_card(torch, device) - held
        out["on" if tie else "off"] = run
    if device.type == "cuda":
        on, off = (out[k]["peak_device_bytes"] for k in ("on", "off"))
        out["peak_spread"] = abs(on - off) / off
        if out["peak_spread"] > TIERED_PEAK_TOL:
            raise AssertionError(f"[tiered] (f) peak device bytes {on} with "
                                 f"the tie-break on against {off} off")
    log(f"[tiered] (f) N = C = {n} at {dim}/{hid}/{lat}, "
        f"{TIERED_KEYED_ROUNDS} rounds ({smi}): tie-break on through keyed "
        f"rows (no [S, C] tensor, the generator untouched), the card's row "
        f"the CPU's bits; peak device {out['on']['peak_device_bytes']} B "
        f"on against {out['off']['peak_device_bytes']} B off (spread "
        f"{out.get('peak_spread')}, limit {TIERED_PEAK_TOL}; residue "
        f"{out['on']['residue_bytes']} / {out['off']['residue_bytes']} B); "
        f"seconds a "
        f"round {json.dumps(out['on']['round_s'])} on, "
        f"{json.dumps(out['off']['round_s'])} off; one [N] hash "
        f"{out['on'].get('hash_ms')} ms eager, "
        f"{out['on'].get('hash_graph_ms')} ms as a graph replay; aggregators "
        f"{out['on']['aggregators']} on, {out['off']['aggregators']} off; "
        f"the keyed run's launches {json.dumps(out['on']['launches'])}")
    del bulk
    return out


def _keyed_config(cfg, n, tie, **kw):
    """(f)'s and (g)'s federation config: the --podscale drivers' widths,
    batch 16, 2 epochs, every client selected, the tie-break on or off."""
    from fedmse_tpu_torch.config import CompatConfig
    dim, hid, lat = TIERED_KEYED_DIMS
    return cfg.replace(dim_features=dim, hidden_neus=hid, latent_dim=lat,
                       network_size=n, epochs=2, batch_size=16,
                       num_participants=1.0,
                       compat=CompatConfig(shared_last_client_val=False,
                                           vote_tie_break=tie), **kw)


def _keyed_row_bits(torch, f, key, n, device) -> bool:
    """A keyed round's vote row, from its own device buffers, at five
    voter positions: the card's bits are the CPU's and the numpy twin's."""
    from fedmse_tpu_torch.federation.voting import KeyedDraws
    from fedmse_tpu_torch.utils.seeding import keyed_uniform_row_np
    src = KeyedDraws(f.tie_key["vote"], f.round_t, f.lane_ids)
    voters = torch.tensor([0, 1, 2, n // 2, n - 1], device=device)
    card = src.rows(voters)
    cpu = KeyedDraws(src.key.cpu(), src.round.cpu(),
                     src.ids.cpu()).rows(voters.cpu())
    twin = keyed_uniform_row_np(key, int(src.round),
                                voters.cpu().numpy()[:, None],
                                src.ids.cpu().numpy())
    return bool(
        torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))
        and np.array_equal(cpu.numpy().view(np.int32), twin.view(np.int32)))


def _round_sheets(torch, f, s, n):
    """The names of a fused round's tensors whose last two axes are the
    [S, N] tie-break sheet's."""
    return [name for name, t in list(vars(f).items())
            + list(f.round_in.items()) + list(f.chunk_in.items())
            if isinstance(t, torch.Tensor) and t.dim() >= 2
            and tuple(t.shape[-2:]) == (s, n)]


def _dense_keyed_run(torch, device, tc, bulk, n):
    """One (g) run (tiered_dense_keyed): a warm round, then
    TIERED_DENSE_TIMED_ROUNDS rounds in one chunk; its record (with its
    own kernel launches), and with the tie-break on the keyed path's
    checks: no sheet, the generator untouched, the round's absolute
    index the last round's, the card's row the CPU's bits and both
    kernels launched in this run. Everything it builds dies at its
    return."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    tie = tc.compat.vote_tie_break
    base = _clear_card(torch, device)
    data = _federation_rows(bulk, n, device)
    launches = {}
    with counted_launches(launches):
        t0 = time.perf_counter()
        eng = RoundEngine(make_model("hybrid", *TIERED_KEYED_DIMS,
                                     tc.shrink_lambda, device=device), tc,
                          data, n, ExperimentRngs(run=0), "hybrid",
                          "mse_avg", fused=True)
        init_s = time.perf_counter() - t0
        init_gen = eng.rngs.generator.get_state()
        t1 = time.perf_counter()
        res = eng.run_rounds(0, 1)
        _sync(torch, device)
        warm_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        res += eng.run_rounds(1, TIERED_DENSE_TIMED_ROUNDS)
        _sync(torch, device)
        sec = (time.perf_counter() - t2) / TIERED_DENSE_TIMED_ROUNDS
    run = {"keyed": eng.keyed_tie_break, "launches": launches,
           "init_s": init_s,
           "warm_round_s": warm_s, "sec_per_round": sec,
           "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                 - base) if device.type == "cuda" else None,
           "aggregators": [r.aggregator for r in res]}
    for r in res:
        if not np.isfinite(r.client_metrics).all():
            raise AssertionError(f"[tiered] (g) tie-break {tie}: round "
                                 f"{r.round_index} metrics not finite")
    if not tie:
        return run
    f = eng.fused_round()
    sheet = _round_sheets(torch, f, eng.cohort_size(), n)
    if not (eng.keyed_tie_break and f.tie_keys is not None and f.u is None
            and f.u_all is None and not sheet
            and torch.equal(eng.rngs.generator.get_state(), init_gen)):
        raise AssertionError(f"[tiered] (g) the keyed path was not taken: "
                             f"sheets {sheet}")
    if int(f.round_t) != TIERED_DENSE_TIMED_ROUNDS:
        raise AssertionError(f"[tiered] (g) the keyed round's index is "
                             f"{int(f.round_t)} after absolute round "
                             f"{TIERED_DENSE_TIMED_ROUNDS}")
    for name in ("fused_ae_forward", "fused_ae_train"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"[tiered] (g) the keyed run never "
                                 f"launched {name}")
    run["row_bits_equal"] = _keyed_row_bits(torch, f, eng.rngs.vote_key(),
                                            n, device)
    if not run["row_bits_equal"]:
        raise AssertionError("[tiered] (g) the keyed row on the card "
                             "differs from the CPU's")
    return run


def tiered_batched_keyed(torch, device, cfg, bulk, n):
    """(g)'s batched half: R = TIERED_BATCH_RUNS runs of N = n gateways,
    every client selected, the tie-break on (each run above the rule at
    (S, n_real)), one round batched and each run alone: the keyed path
    taken (no [R, S, N] buffer) and each run's selection and election
    the run's alone; the launches of both in the record."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.batched import BatchedRunEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    runs = TIERED_BATCH_RUNS
    tc = _keyed_config(cfg, n, True, num_rounds=1)
    data = _federation_rows(bulk, n, device)
    model = make_model("hybrid", *TIERED_KEYED_DIMS, tc.shrink_lambda,
                       device=device)
    _clear_card(torch, device)
    launches = {}
    with counted_launches(launches):
        t0 = time.perf_counter()
        bat = BatchedRunEngine(model, tc, data, n, runs, "hybrid",
                               "mse_avg")
        outs, sched, _ = bat.run_schedule_chunk(0, 1, np.ones(runs, bool))
        _sync(torch, device)
        batched_s = time.perf_counter() - t0
        f = bat.fused_round()
        sheet = _round_sheets(torch, f, bat.cohort_size(), n)
        if not (bat.keyed_tie_break and f.u is None and f.u_all is None
                and not sheet):
            raise AssertionError(f"[tiered] (g) the batched keyed path was "
                                 f"not taken: sheets {sheet}")
        del bat, f
        alone = []
        for r in range(runs):
            eng = RoundEngine(model, tc, data, n,
                              ExperimentRngs(run=r, data_seed=tc.data_seed,
                                             run_seed_stride=tc.
                                             run_seed_stride),
                              "hybrid", "mse_avg", fused=True)
            res = eng.run_rounds(0, 1)[0]
            alone.append((res.selected, res.aggregator))
            del eng
    out = {"n": n, "runs": runs, "batched_s": batched_s,
           "launches": launches,
           "batched": [None if o.aggregator < 0 else o.aggregator
                       for o in outs[0]],
           "alone": [a for _, a in alone]}
    for r in range(runs):
        if list(sched[0][r]) != list(alone[r][0]) \
                or out["batched"][r] != alone[r][1]:
            raise AssertionError(f"[tiered] (g) batched run {r} elected "
                                 f"{out['batched'][r]}, alone "
                                 f"{alone[r][1]}")
    return out


def tiered_dense_keyed(torch, device, cfg, n, smi):
    """(g) The dense fused engine at N = n bulk gateways at (f)'s widths,
    batch 16, every client selected (S = N), hybrid / mse_avg: a warm
    round and TIERED_DENSE_TIMED_ROUNDS timed rounds with the vote
    tie-break on (above the size rule at (S, N): keyed rows, no [S, N]
    sheet) and off. Raises unless the keyed path was taken (no S x N
    buffer in the round, the generator untouched by tie-breaks), a keyed
    row on the card is the CPU's bits, the peak device bytes with the
    tie-break on are within TIERED_DENSE_PEAK_TOL of off, and both
    kernels launched in the keyed run; then tiered_batched_keyed at
    TIERED_BATCH_N. The record's launches are the three runs' sum."""
    from fedmse_tpu_torch.federation.voting import keyed_tie_break
    kc = _keyed_config(cfg, n, True,
                       num_rounds=1 + TIERED_DENSE_TIMED_ROUNDS)
    if not keyed_tie_break(kc, n, n):
        raise AssertionError(f"[tiered] (g) N = {n} is under the size rule")
    t0 = time.perf_counter()
    bulk = bulk_federation(torch, n, TIERED_KEYED_DIMS[0], kc.batch_size,
                           SEED + 23)
    out = {"n": n, "cohort": n, "dims": list(TIERED_KEYED_DIMS),
           "timed_rounds": TIERED_DENSE_TIMED_ROUNDS, "device": smi,
           "launches": {}}
    for tie in (True, False):
        tc = _keyed_config(cfg, n, tie,
                           num_rounds=1 + TIERED_DENSE_TIMED_ROUNDS)
        out["on" if tie else "off"] = _dense_keyed_run(
            torch, device, tc, bulk, n)
    _clear_card(torch, device)
    if device.type == "cuda":
        on, off = (out[k]["peak_device_bytes"] for k in ("on", "off"))
        out["peak_spread"] = abs(on - off) / off
        if out["peak_spread"] > TIERED_DENSE_PEAK_TOL:
            raise AssertionError(f"[tiered] (g) peak device bytes {on} with "
                                 f"the tie-break on against {off} off")
    out["batched"] = tiered_batched_keyed(torch, device, cfg, bulk,
                                          min(TIERED_BATCH_N, n))
    for part in (out["on"], out["off"], out["batched"]):
        for name, k in part["launches"].items():
            out["launches"][name] = out["launches"].get(name, 0) + k
    out["seconds"] = time.perf_counter() - t0
    b = out["batched"]
    log(f"[tiered] (g) dense fused engine at N = S = {n}, "
        f"{'/'.join(map(str, TIERED_KEYED_DIMS))}, batch 16 ({smi}): "
        f"tie-break on through keyed rows (no [S, N] buffer, the generator "
        f"untouched, the card's row the CPU's bits) "
        f"{out['on']['sec_per_round']:.4f} s/round over "
        f"{TIERED_DENSE_TIMED_ROUNDS} rounds (warm "
        f"{out['on']['warm_round_s']:.3f} s), off "
        f"{out['off']['sec_per_round']:.4f} s/round (warm "
        f"{out['off']['warm_round_s']:.3f} s); peak device "
        f"{out['on']['peak_device_bytes']} B on against "
        f"{out['off']['peak_device_bytes']} B off (spread "
        f"{out.get('peak_spread')}, limit {TIERED_DENSE_PEAK_TOL}); "
        f"aggregators {out['on']['aggregators']} on, "
        f"{out['off']['aggregators']} off; batched R = {b['runs']} at "
        f"N = {b['n']} keyed elected {b['batched']}, each run alone "
        f"{b['alone']} ({b['batched_s']:.3f} s batched); launches "
        f"{json.dumps(out['launches'])}; {out['seconds']:.1f} s")
    del bulk
    return out


def phase_tiered(torch, device, cfg, clients, data, smi):
    """The tiered state layout (--state-layout tiered): (e) the kernels at
    its shapes; then the tiered path, launch counters set to 0 before it
    and read after it: (a) C == N against the dense engine, (b) C < N,
    prefetched against serial, (c) the full-size runs at every N of
    TIERED_FLEETS, whose peak device bytes must agree within
    TIERED_PEAK_TOL, and (f) the largest N at full participation with the
    tie-break on, through keyed rows; after it (d) the dense engine at
    the largest N."""
    t0 = time.perf_counter()
    n = len(clients)
    report = {"kernels": tiered_kernel_shapes(torch, device, TIERED_COHORT)}
    TIERED_LAUNCHES.clear()
    report["full_participation"] = tiered_vs_dense(torch, device, cfg, data,
                                                   n)
    report["partial"] = tiered_partial(torch, device, cfg, data, n)
    big = max(TIERED_FLEETS)
    t1 = time.perf_counter()
    bulk = bulk_federation(torch, big, DIMS[0], cfg.batch_size, SEED + 20)
    report["bulk_data_s"] = time.perf_counter() - t1
    report["full_size"] = [tiered_full_size(torch, device, cfg, bulk, m, smi)
                           for m in TIERED_FLEETS]
    report["keyed"] = tiered_keyed_tie_break(torch, device, cfg, big, smi)
    report["launches"] = dict(TIERED_LAUNCHES)
    for name in ("fused_ae_forward", "fused_ae_train"):
        if report["launches"][name] < 1:
            raise AssertionError(f"the tiered path never launched {name}")
    log(f"[tiered] tiered path launches {json.dumps(report['launches'])}")
    if device.type == "cuda":
        peaks = [r["peak_device_bytes"] for r in report["full_size"]]
        spread = (max(peaks) - min(peaks)) / min(peaks)
        report["peak_device_spread"] = spread
        log(f"[tiered] peak device bytes at N = {list(TIERED_FLEETS)}: "
            f"{peaks} (spread {spread:.4f}, limit {TIERED_PEAK_TOL})")
        if spread > TIERED_PEAK_TOL:
            raise AssertionError(f"[tiered] the card's footprint moved "
                                 f"{spread:.4f} with N")
    report["dense_at_scale"] = tiered_dense_at_scale(torch, device, cfg,
                                                     bulk, big, smi)
    del bulk
    report["dense_keyed"] = tiered_dense_keyed(torch, device, cfg, big, smi)
    report["seconds"] = time.perf_counter() - t0
    log(f"[tiered] done in {report['seconds']:.1f} s")
    return report


# ---- the flywheel control loop (phase "flywheel") ---- #

# interleaved test rows each pass streams, (b): all of them (10 gateways
# x 3,000), since each gateway's 1,000 normal test rows come before its
# 2,000 attack rows and a shorter stream would hold no attack to score
FLYWHEEL_ROWS = 30_000
# the synthetic fleet's rows are isotropic N(0, 1) per feature, so a shift
# of s along one unit direction moves each feature by s / sqrt(D) (RMS):
# the config's 1.5 feature-stds moves the served scores by < 0.1
# calibration stds there, and no monitor sees it. The pass shifts by 1.5
# feature-stds per feature instead, 1.5 sqrt(D) along the direction
FLYWHEEL_SHIFT_PER_FEATURE = 1.5
# (b) the drift-recovery cells (drift_recovery_sweep.py's regime at the
# paper's width): normals on a rank-3 manifold plus 0.2 noise in D dims,
# the regime walking `delta` along a unit direction (`on_frac` of it
# on the manifold) while attacks replay pre-deployment traffic `behind`
# the origin; 10 gateways of 240 train, 80 valid, 60 + 60 test rows,
# 288 rows a gateway per stage
RECOVERY_CELLS = (
    dict(model_type="hybrid", score_kind="centroid", delta=1.5, stages=3,
         on_frac=0.5, behind=1.25, z=0.5),
    dict(model_type="autoencoder", score_kind="knn", delta=2.8, stages=2,
         on_frac=1.0, behind=2.5, z=0.35))
FLYWHEEL_ADV_STEPS = 48  # served batches of the slow-drift walk, (e)
FLYWHEEL_TOL = 1e-4      # (c): one fine-tune epoch, card vs CPU
FLYWHEEL_LAUNCHES = {}   # the flywheel path's kernel launches, by wrapper


def family_wrappers(family: str) -> dict:
    """The wrappers of the kernels a model family's main path launches
    (ops/graphs.FAMILY_KERNELS), by name."""
    from fedmse_tpu_torch.ops.graphs import FAMILY_KERNELS, WRAPPERS
    return {k: WRAPPERS[k] for k in FAMILY_KERNELS[family]}


@contextlib.contextmanager
def counted_launches(store):
    """Count the kernel launches of the work inside: every count set to 0
    just before and read just after, added into `store`."""
    WRAPPERS = family_wrappers("autoencoder")
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for k, w in WRAPPERS.items():
        store[k] = store.get(k, 0) + w.launches


def routed_kernel_shapes(torch, device, tag, g, buckets, dist_rows=()):
    """The forward kernel at a path's own shapes against its plain
    version, f32 on dyadic grids, each case also bit-equal to a second
    call: `g` routed models, each (rows, layout) of `buckets`
    routed at random, packed in 64-row sessions of one gateway each (a
    gateway frontend's bursts) or client-major (an engine's fit over its
    train rows); then the distance kernel, `g` 512-slot banks against
    each of `dist_rows` query rows, routed at random (a kNN bucket), or
    as given by a (rows, layout) entry."""
    from fedmse_tpu_torch.knn.score import dist_tiles
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    gen = torch.Generator().manual_seed(SEED + 44)
    params = grid_params(torch, g, *DIMS, gen, device, torch.float32)
    worst = {}
    for rows, kind in buckets:
        x = (torch.randint(-6, 7, (rows, DIMS[0]), generator=gen) / 4.0
             ).to(device)
        if kind == "sessions":
            idx = torch.randint(0, g, (-(-rows // 64),), generator=gen,
                                dtype=torch.int32).repeat_interleave(64)
            idx = idx[:rows].to(device)
        else:
            idx = forward_index(torch, kind, g, rows, gen, device)
        got = fused_forward_stats(params, x, idx)
        if not all(torch.equal(a, c) for a, c in zip(
                got, fused_forward_stats(params, x, idx))):
            raise AssertionError(f"[{tag}] forward at {rows} rows {kind}: "
                                 "not bit-equal to a second call")
        worst[f"forward, {rows} rows {kind}, {g} models"] = max(
            scaled_err(a, c) for a, c in zip(
                got, fused_forward_stats_plain(params, x, idx)))
    for rows in dist_rows:
        rows, kind = (rows, "random") if isinstance(rows, int) else rows
        q, banks, gw = dist_inputs(torch, g, rows, KNN["knn_bank_size"],
                                   DIMS[2], kind, gen, device,
                                   torch.float32)
        what = (f"distances, {rows} rows x {g} banks of "
                f"{KNN['knn_bank_size']}")
        got, _, worst[what] = dist_check(torch, q, banks, gw, what)
        if not torch.equal(got, dist_tiles(q, banks, gw)):
            raise AssertionError(f"[{tag}] {what}: not bit-equal to a "
                                 "second call")
    bad = {k: v for k, v in worst.items()
           if v > (DIST_TOL if k.startswith("dist") else TOL["f32"])}
    if bad:
        raise AssertionError(f"[{tag}] kernels vs plain: {bad}")
    return worst


def flywheel_kernel_shapes(torch, device, n):
    """(a) The kernels at the flywheel's own shapes against their plain
    versions, f32 on dyadic grids, each also bit-equal to a second call:
    the fine-tune's train step at G = n over a full reservoir's 32
    batches of 12 (the last one part-masked for one client), the routed
    candidate-scoring forward over every gateway's held-out rows (128
    each, gateway-major), the bank refresh's encode of [n, 384, D], and
    the distances of a serving bucket (256 rows) to n 512-slot banks."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 30)
    layout = ParamLayout(*DIMS)
    kw = dict(layout=layout, shrink_lambda=10.0)
    worst = {}
    flat, xt = grid_inputs(torch, layout, n, 32 * 12, gen, device)
    m = torch.ones((n, 32 * 12), device=device)
    m[-1, -7:] = 0.0  # a reservoir short of full
    err = 0.0
    for b in range(32):
        x, mb = xt[:, b * 12:(b + 1) * 12], m[:, b * 12:(b + 1) * 12]
        x, mb = x.contiguous(), mb.contiguous()
        got = fused_train_grads(flat, x, mb, **kw)
        again = fused_train_grads(flat, x, mb, **kw)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"[flywheel] train step, batch {b}: not "
                                 "bit-equal to a second call")
        err = max(err, max(scaled_err(a, c) for a, c in zip(
            got, fused_train_grads_plain(flat, x, mb, **kw))))
    worst[f"train step, G = {n}, 32 batches of 12"] = err
    if err > TOL["f32"]:
        raise AssertionError(f"[flywheel] train step vs plain: {err:.3e}")
    worst.update(routed_kernel_shapes(
        torch, device, "flywheel", n,
        [(n * 128, "client_major"), (n * 384, "client_major")],
        dist_rows=(256,)))
    log(f"[flywheel] (a) kernels at the flywheel's shapes agree with their "
        f"plain versions and with a second call: {json.dumps(worst)}")
    return worst


class FlywheelWatch:
    """The observer of one flywheel pass (run_flywheel_smoke's on_chunk):
    after every streamed chunk the served params must be the bits they
    were at the last install, and every fine-tune (wrapped at the first
    chunk) must start from the served params and leave them as they were.
    Counts the rows served while a fine-tune is pending and keeps each
    fine-tune's inputs and output."""

    def __init__(self, torch):
        self.torch = torch
        self.ctl = None
        self.snap = None
        self.swaps = 0
        self.runs = []
        self.pending_rows = 0
        self.pending_chunks = 0
        self.served = 0
        self.was_pending = False

    def _flat(self):
        engine = self.ctl.batcher.engine
        return self.ctl.runner.layout.flatten(engine.params)

    def _wrap(self):
        torch, runner, orig = self.torch, self.ctl.runner, \
            self.ctl.runner.run

        def run(finetune, warm, rngs, rounds, assignment=None):
            served = self._flat()
            if not torch.equal(served, warm):
                raise AssertionError("[flywheel] the fine-tune's warm start "
                                     "is not the served params")
            warm0 = warm.clone()
            t0 = time.perf_counter()
            out = orig(finetune, warm, rngs, rounds, assignment)
            torch.cuda.synchronize()
            if not torch.equal(self._flat(), served):
                raise AssertionError("[flywheel] the fine-tune changed the "
                                     "served params before the install")
            self.runs.append({"finetune": finetune, "warm": warm0,
                              "run": rngs.run, "rounds": rounds,
                              "cfg": runner.cfg,
                              "params": runner.layout.flatten(out[0]),
                              "reused": out[2],
                              "seconds": time.perf_counter() - t0})
            return out

        runner.run = run

    def __call__(self, stage, k, controller):
        torch = self.torch
        if self.ctl is None:
            self.ctl = controller
            self._wrap()
            self.snap, self.swaps = self._flat(), 0
        engine, batcher = controller.batcher.engine, controller.batcher
        if engine.swap_count != self.swaps:
            self.snap, self.swaps = self._flat(), engine.swap_count
        elif not torch.equal(self._flat(), self.snap):
            raise AssertionError(f"[flywheel] served params changed at "
                                 f"stage {stage} chunk {k} without an "
                                 "install")
        if self.was_pending:
            self.pending_rows += batcher.rows_served - self.served
            self.pending_chunks += 1
        self.served = batcher.rows_served
        self.was_pending = controller.finetune_pending


def flywheel_pass(torch, cfg, data, writer, names, score_kind,
                  background=False):
    """(b) / (d) One closed-loop pass (flywheel.run_flywheel_smoke, the
    CLI's --flywheel) on the trained hybrid / mse_avg checkpoint with
    `score_kind`, the fine-tune synchronous or in the background, the
    shift FLYWHEEL_SHIFT_PER_FEATURE feature-stds per feature: at least
    one swap, no ticket dropped, rows served == submitted, finite AUCs,
    the served params the installed bits throughout. The AUCs are
    reported: on this fleet the attacks sit ~4 stds out in every feature,
    so the stale detector barely degrades and a fine-tune on 384 rows a
    gateway can only lose (the recovery cells hold adapted > stale).
    Returns (report row, watch)."""
    from fedmse_tpu_torch.flywheel import run_flywheel_smoke
    c = cfg.replace(score_kind=score_kind, flywheel_async=background, **KNN)
    watch = FlywheelWatch(torch)
    t0 = time.perf_counter()
    shift = FLYWHEEL_SHIFT_PER_FEATURE * DIMS[0] ** 0.5
    rep = run_flywheel_smoke(c, data, len(names), writer, names, "hybrid",
                             "mse_avg", run=0, max_rows=FLYWHEEL_ROWS,
                             shift_sigma=shift, on_chunk=watch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    events = rep["events"]
    st = rep["batcher"]
    row = {
        "score_kind": rep["score_kind"], "background": background,
        "shift": shift, "seconds": secs,
        "auc_pre_shift": rep["auc_pre_shift"],
        "auc_post_shift_stale": rep["auc_post_shift_stale"],
        "auc_post_shift_adapted": rep["auc_post_shift_adapted"],
        "swap_events": len(events),
        "trigger_gateways": [e["flywheel"]["trigger_gateways"]
                             for e in events],
        "eligible_gateways": [e["flywheel"]["eligible_gateways"]
                              for e in events],
        "finetune_seconds": [e["flywheel"]["finetune_seconds"]
                             for e in events],
        "finetune_run_seconds": [r["seconds"] for r in watch.runs],
        "finetune_engine_reused": [r["reused"] for r in watch.runs],
        "install_seconds": [e["flywheel"]["install_seconds"]
                            for e in events],
        "tickets": rep["tickets"],
        "rows_served": st["rows_served"],
        "rows_submitted": st["rows_submitted"],
        "rows_served_while_pending": watch.pending_rows,
        "chunks_while_pending": watch.pending_chunks,
        "buffer_fill": rep["buffer"]["fill_fraction"],
        "latency_p99_ms": st["latency_p99_ms"]}
    tag = f"{score_kind}{', background' if background else ''}"
    log(f"[flywheel] {'(d)' if background else '(b)'} {tag}: "
        f"{json.dumps(row)}")
    aucs = [row[k] for k in ("auc_pre_shift", "auc_post_shift_stale",
                             "auc_post_shift_adapted")]
    if not (row["swap_events"] >= 1 and rep["tickets"]["zero_dropped"]
            and st["rows_served"] == st["rows_submitted"]
            == rep["tickets"]["rows_submitted"]
            and np.isfinite(aucs).all()
            and len(watch.runs) == row["swap_events"]):
        raise AssertionError(f"[flywheel] {tag} pass: {json.dumps(row)}")
    if background and watch.pending_rows < 1:
        raise AssertionError("[flywheel] (d) no row was served while the "
                             "background fine-tune was pending")
    return row, watch


def flywheel_recovery_cell(torch, cfg, device, model_type, score_kind,
                           delta, stages, on_frac, behind, z, n=10,
                           rank=3, noise=0.2, rows=288, hold=2, seed=0):
    """(b) One drift-recovery cell at the paper's width (RECOVERY_CELLS):
    train the federation on the calibrated regime (the fused round, the
    quick run's 3 rounds of 5 epochs), serve it through the continuous
    front with the flywheel (drift_recovery_sweep.py's knobs: 384-row
    reservoirs, 5 fine-tune rounds, quorum 2, monitor cooldown 3),
    stream the calibrated regime, the walk in `stages` and `hold` stages
    at its end; then the detection AUC of the walked regime's normals
    against the replayed attacks, live and on a frozen engine. Asserts
    at least one swap, no ticket dropped, the served params the
    installed bits throughout, and adapted AUC above the stale one."""
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.data.loader import ClientData
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.flywheel import (FlywheelBuffer,
                                           FlywheelController, host_auc,
                                           stream_with_polling,
                                           ticket_integrity)
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                          ServingEngine, fit_calibration)
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    dim = DIMS[0]
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rank, dim))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    q, _ = np.linalg.qr(w.T)
    u = rng.normal(size=dim)
    u -= q @ (q.T @ u)
    u /= np.linalg.norm(u)
    u = np.sqrt(1.0 - on_frac) * u + np.sqrt(on_frac) * w[0]

    def normals(r, k, shift=0.0):
        x = r.normal(size=(k, rank)) @ w + noise * r.normal(size=(k, dim))
        return (x + shift * u).astype(np.float32)

    c = cfg.replace(network_size=n, score_kind=score_kind, knn_bank_size=128,
                    flywheel_buffer_size=384, flywheel_rounds=5,
                    flywheel_quorum=2, flywheel_cooldown=3,
                    flywheel_min_rows=160, flywheel_z=z,
                    flywheel_percentile=99.0)
    rngs = ExperimentRngs(run=0)
    r = np.random.default_rng(1000 + seed)
    clients = [ClientData(
        name=f"recovery-{i + 1}", train_x=normals(r, 240),
        valid_x=normals(r, 80),
        test_x=np.concatenate([normals(r, 60), normals(r, 60, -behind)]),
        test_y=np.concatenate([np.zeros(60), np.ones(60)]).astype(
            np.float32), dev_raw=normals(r, 120), scaler=None)
        for i in range(n)]
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         c.batch_size, device=device)
    model = make_model(model_type, *DIMS, c.shrink_lambda, device=device)
    trainer = RoundEngine(model, c, data, n_real=n, rngs=rngs,
                          model_type=model_type, update_type="mse_avg",
                          fused=True)
    trainer.run_rounds(0, c.num_rounds)
    params = trainer.model_params()

    def build():
        return ServingEngine.from_federation(
            model, model_type, params, train_x=data.train_xb,
            train_m=data.train_mb, score_kind=score_kind,
            knn_bank_size=c.knn_bank_size, knn_k=c.knn_k, max_bucket=256,
            device=device)

    engine, frozen = build(), build()
    calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                            data.valid_m.cpu().numpy(), percentile=99.0)
    monitor = DriftMonitor(calib, z_threshold=z, min_batches=2,
                           cooldown_updates=c.flywheel_cooldown)
    buf = FlywheelBuffer(n, dim, capacity=c.flywheel_buffer_size, seed=seed)
    front = ContinuousBatcher(engine, max_batch=64, latency_budget_ms=1e9,
                              calibration=calib, drift=monitor,
                              intake=buf.tap())
    ctl = FlywheelController(front, monitor, buf, model, model_type,
                             "mse_avg", c, dev_x=data.dev_x.cpu().numpy(),
                             rounds=c.flywheel_rounds, quorum=2,
                             cooldown_polls=4,
                             min_rows=c.flywheel_min_rows)
    watch = FlywheelWatch(torch)

    def auc(score, shift):
        e = np.random.default_rng(200 + seed)
        xs = np.concatenate([normals(e, 384, shift),
                             normals(e, 384, -behind)])
        ys = np.concatenate([np.zeros(384), np.ones(384)])
        g = np.tile(np.arange(n, dtype=np.int32),
                    -(-len(xs) // n))[:len(xs)]
        return host_auc(ys, score(xs, g))

    stream = np.random.default_rng(100 + seed)
    gws = np.tile(np.arange(n, dtype=np.int32), rows)
    pre = auc(engine.score, 0.0)
    blocks = []
    for stage in range(stages + hold + 1):
        shift = delta * min(stage, stages) / stages
        b, _ = stream_with_polling(
            front, ctl, normals(stream, rows * n, shift), gws,
            on_chunk=lambda k, ctl_, st=stage: watch(st, k, ctl_))
        blocks += b
    st = front.stats()
    out = {"model_type": model_type, "score_kind": score_kind,
           "delta": delta, "stages": stages, "on_frac": on_frac,
           "behind": behind, "z": z, "auc_pre_shift": pre,
           "auc_adapted": auc(engine.score, delta),
           "auc_stale": auc(frozen.score, delta),
           "swaps": len(ctl.events),
           "trigger_gateways": [e["flywheel"]["trigger_gateways"]
                                for e in ctl.events],
           "finetune_seconds": [e["flywheel"]["finetune_seconds"]
                                for e in ctl.events],
           "finetune_engine_reused": [x["reused"] for x in watch.runs],
           "install_seconds": [e["flywheel"]["install_seconds"]
                               for e in ctl.events],
           "tickets": ticket_integrity(blocks),
           "rows_served": st["rows_served"],
           "rows_submitted": st["rows_submitted"]}
    log(f"[flywheel] (b) recovery cell {model_type}/{score_kind}: "
        f"{json.dumps(out)}")
    if not (out["swaps"] >= 1 and out["tickets"]["zero_dropped"]
            and st["rows_served"] == st["rows_submitted"]
            and out["auc_adapted"] > out["auc_stale"]):
        raise AssertionError(f"[flywheel] recovery cell: {json.dumps(out)}")
    return out


def _finetune_on(torch, device, run, epochs=None):
    """The fine-tune of `run` (a FlywheelWatch entry) again on `device`:
    a fresh runner, the same config (`epochs` of them if given), data,
    warm params and streams; returns the flat params."""
    from fedmse_tpu_torch.flywheel import FinetuneRunner
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = run["cfg"] if epochs is None else run["cfg"].replace(
        epochs=epochs)
    n = len(run["finetune"].eligible)
    runner = FinetuneRunner(
        make_model("hybrid", *DIMS, cfg.shrink_lambda,
                   precision=cfg.precision, device=device), cfg, "hybrid",
        "mse_avg", n, torch.device(device))
    tree, _, _ = runner.run(run["finetune"], run["warm"].clone(),
                            ExperimentRngs(run=run["run"]),
                            1 if epochs is not None else run["rounds"])
    return runner.layout.flatten(tree)


def flywheel_adversary(torch, cfg, data, writer, names):
    """(e) The slow-drift adversary (redteam.SlowDriftAdversary) walks
    captive gateway 0 from its normal mean toward its attack mean against
    the live flywheel (kNN score, synchronous fine-tune): each step serves
    one honest interleaved chunk and the adversary's batch, ticks the
    controller and feeds the adversary its rows' verdicts. Reports the
    position reached and the share of its target rows verdicted normal
    before and after each swap (finite, not asserted further)."""
    from fedmse_tpu_torch.flywheel import (FlywheelBuffer,
                                           FlywheelController)
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.redteam import SlowDriftAdversary, normal_fraction
    from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                          ServingEngine, fit_calibration,
                                          interleave_test_rows)
    from fedmse_tpu_torch.serving.smoke import _host
    c = cfg.replace(score_kind="knn", **KNN)
    n, dev = len(names), data.train_xb.device
    model = make_model("hybrid", *DIMS, device=dev)
    engine = ServingEngine.from_checkpoint(
        writer, model, "hybrid", "mse_avg", names, train_x=data.train_xb,
        train_m=data.train_mb, max_bucket=c.serve_max_batch,
        score_kind="knn", knn_bank_size=c.knn_bank_size, knn_k=c.knn_k,
        knn_topk=c.knn_topk, device=dev)
    calib = fit_calibration(engine, _host(data.valid_x), _host(data.valid_m),
                            percentile=c.flywheel_percentile)
    monitor = DriftMonitor(calib, z_threshold=c.flywheel_z, min_batches=2,
                           cooldown_updates=c.flywheel_cooldown)
    buf = FlywheelBuffer(n, DIMS[0], capacity=c.flywheel_buffer_size,
                         seed=SEED)
    front = ContinuousBatcher(engine, max_batch=c.serve_max_batch,
                              latency_budget_ms=c.serve_latency_budget_ms,
                              calibration=calib, drift=monitor,
                              intake=buf.tap())
    ctl = FlywheelController(front, monitor, buf, model, "hybrid", "mse_avg",
                             c, dev_x=_host(data.dev_x),
                             rounds=c.flywheel_rounds,
                             quorum=c.flywheel_quorum,
                             min_rows=c.flywheel_min_rows)
    test_x, test_m, test_y = (_host(data.test_x), _host(data.test_m),
                              _host(data.test_y))
    rows, gws, labels = interleave_test_rows(test_x, test_m, test_y,
                                             FLYWHEEL_ROWS)
    honest, hg = rows[labels <= 0], gws[labels <= 0]
    train0 = _host(data.train_xb)[0].reshape(-1, DIMS[0])
    keep = _host(data.train_mb)[0].reshape(-1) > 0
    attack0 = test_x[0][(test_m[0] > 0) & (test_y[0] > 0)]
    adv = SlowDriftAdversary(train0[keep].mean(axis=0), attack0.mean(axis=0),
                             seed=SEED, step=0.05)
    probe = adv.target_rows(256, seed=SEED + 1)

    def target_normal():
        g0 = np.zeros(len(probe), np.int32)
        return normal_fraction(front.calibration.verdicts(
            engine.score(probe, g0), g0))

    shares = [{"after_swaps": 0, "target_normal": target_normal()}]
    positions, chunk = [], 64
    for t in range(FLYWHEEL_ADV_STEPS):
        s = (t * chunk) % max(1, len(honest) - chunk)
        blk = front.submit_many(honest[s:s + chunk], hg[s:s + chunk])
        ab = front.submit_many(adv.next_batch(32), np.zeros(32, np.int32))
        front.drain()
        event = ctl.poll()
        adv.observe(normal_fraction(ab.verdicts))
        positions.append(adv.position)
        if event is not None:
            shares.append({"after_swaps": len(ctl.events), "step": t,
                           "position": adv.position,
                           "target_normal": target_normal()})
        if not blk.done:
            raise AssertionError("[flywheel] (e) an honest chunk unresolved")
    st = front.stats()
    out = {"steps": FLYWHEEL_ADV_STEPS, "final_position": adv.position,
           "max_position": max(positions), "swaps": len(ctl.events),
           "trigger_gateways": [e["flywheel"]["trigger_gateways"]
                                for e in ctl.events],
           "target_normal_share": shares,
           "admitted_gateway0": int(buf.seen[0]),
           "rows_served": st["rows_served"],
           "rows_submitted": st["rows_submitted"]}
    finite = [out["final_position"]] + [x["target_normal"] for x in shares]
    if not np.isfinite(finite).all() or \
            st["rows_served"] != st["rows_submitted"]:
        raise AssertionError(f"[flywheel] (e) {json.dumps(out)}")
    log(f"[flywheel] (e) slow-drift adversary on gateway 0: "
        f"{json.dumps(out)}")
    return out


def phase_flywheel(torch, device, cfg, data, writer, names, smi):
    """The flywheel control loop (--flywheel) on the trained hybrid /
    mse_avg checkpoint of the main path, 10 gateways at 115/27/7: (a) the
    kernels at its shapes; the flywheel path, launch counters set to 0
    before it and read after it: (b) the closed loop with the kNN score
    and with the centroid score, and the drift-recovery cells; then (c)
    the first fine-tune, cut to one
    epoch, on the card and the CPU; (d) the loop with the fine-tune in
    the background, its first fine-tune the synchronous bits from the
    same snapshot; (e) the slow-drift adversary against the live loop."""
    t0 = time.perf_counter()
    n = len(names)
    report = {"kernels": flywheel_kernel_shapes(torch, device, n)}
    FLYWHEEL_LAUNCHES.clear()
    with counted_launches(FLYWHEEL_LAUNCHES):
        knn, watch = flywheel_pass(torch, cfg, data, writer, names, "knn")
        centroid, _ = flywheel_pass(torch, cfg, data, writer, names,
                                    "centroid")
        report["recovery"] = [flywheel_recovery_cell(torch, cfg, device,
                                                     **cell)
                              for cell in RECOVERY_CELLS]
    report["launches"] = dict(FLYWHEEL_LAUNCHES)
    for name, k in report["launches"].items():
        if k < 1:
            raise AssertionError(f"the flywheel path never launched {name}")
    log(f"[flywheel] flywheel path launches "
        f"{json.dumps(report['launches'])}")
    report["passes"] = [knn, centroid]
    first = watch.runs[0]
    card = _finetune_on(torch, device, first, epochs=1)
    cpu = _finetune_on(torch, "cpu", first, epochs=1)
    err = scaled_err(card.cpu(), cpu)
    report["card_vs_cpu_scaled_err"] = err
    log(f"[flywheel] (c) first fine-tune (gateways "
        f"{np.flatnonzero(first['finetune'].eligible).tolist()}) cut to "
        f"one epoch, card vs CPU: max scaled error {err:.3e} (limit "
        f"{FLYWHEEL_TOL:.0e})")
    if not err <= FLYWHEEL_TOL:
        raise AssertionError(f"[flywheel] (c) card vs CPU {err:.3e}")
    background, awatch = flywheel_pass(torch, cfg, data, writer, names,
                                       "knn", background=True)
    run = awatch.runs[0]
    again = _finetune_on(torch, device, run)
    same = torch.equal(again, run["params"])
    background["first_finetune_equals_synchronous_bits"] = same
    log(f"[flywheel] (d) the background fine-tune's params "
        f"{'equal' if same else 'DIFFER from'} the synchronous fine-tune's "
        f"bits from the same snapshot")
    if not same:
        raise AssertionError("[flywheel] (d) background fine-tune bits "
                             "differ from the synchronous ones")
    report["background"] = background
    report["adversary"] = flywheel_adversary(torch, cfg, data, writer, names)
    report["seconds"] = time.perf_counter() - t0
    log(f"[flywheel] done in {report['seconds']:.1f} s ({smi})")
    return report


# ---- the measured autotuner (phase "tune") ---- #

def phase_tune(torch, device, cfg, data, writer, names, smi):
    """The autotuner (tune/) on the card, into a temporary cache file:
    tune_serve_ladder(max_bucket=1024, dim=115) and tune_tier_chunk()
    with every candidate's wall; an engine with bucket_ladder="auto" on
    that cache serves the chosen ladder, and its f32 scores over 8,192
    interleaved rows (centroid and kNN) equal the pow2 engine's bits per
    row, as do pow2_mid's; a tier built from the tuned chunk, and the
    tiered engine's init_chunk=None, equal the dense init's bits; another
    device name misses."""
    import tempfile
    from fedmse_tpu_torch.federation import TieredClientStore
    from fedmse_tpu_torch.federation.state import init_client_states
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.serving import ServingEngine, interleave_order
    from fedmse_tpu_torch.tune import TuningCache, sites
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tune-")
    path = os.path.join(tmp, "TUNE_CACHE_TORCH.json")
    cache = TuningCache(path, writable=True)
    ladder = sites.tune_serve_ladder(max_bucket=1024, dim=DIMS[0],
                                     cache=cache, device=device)
    chunk = sites.tune_tier_chunk(cache=cache, device=device)
    log(f"[tune] serve ladder ({smi}): rung walls "
        f"{json.dumps(ladder['rung_walls'])} s; expected wall per "
        f"request {json.dumps(ladder['expected_wall_s'])} s; chosen "
        f"{ladder['ladder_name']}")
    log(f"[tune] tier init chunk at {chunk['signature']['probe_clients']} "
        f"clients: {json.dumps(chunk['candidates'])}; chosen "
        f"{chunk['choice']}")
    report = {"ladder": {k: ladder[k] for k in (
        "choice", "ladder_name", "expected_wall_s", "rung_walls")},
        "tier_chunk": {k: chunk[k] for k in ("choice", "candidates")}}
    if not (json.load(open(path))["sites"].keys()
            >= {"serve_bucket_ladder", "tier_init_chunk"}):
        raise AssertionError("[tune] the cache file lacks an entry")
    other = {**ladder["signature"], "device": "another card"}
    if cache.lookup("serve_bucket_ladder", other) is not None or (
            device.type == "cuda" and sites.lookup_serve_ladder(
                1024, DIMS[0], cache=cache, device="cpu") is not None):
        raise AssertionError("[tune] another device's signature matched")
    old_env = os.environ.get("FEDMSE_TUNE_CACHE")
    os.environ["FEDMSE_TUNE_CACHE"] = path
    try:
        model = make_model("hybrid", *DIMS, device=device)
        gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
        rows = data.test_x.cpu().numpy()[gws, ridx]
        sizes = sites.probe_sizes(1024)
        report["scores_equal"] = {}
        for kind in ("centroid", "knn"):
            def engine(ladder_arg):
                return ServingEngine.from_checkpoint(
                    writer, model, "hybrid", "mse_avg", names,
                    train_x=data.train_xb, train_m=data.train_mb,
                    max_bucket=1024, bucket_ladder=ladder_arg,
                    score_kind=kind, device=device, **KNN)

            def served(eng):
                out, s, i = [], 0, 0
                while s < len(rows):
                    take = sizes[i % len(sizes)]
                    out.append(eng.score(rows[s:s + take], gws[s:s + take]))
                    s, i = s + take, i + 1
                return np.concatenate(out)

            auto, pow2 = engine("auto"), engine("pow2")
            if auto.buckets != ladder["choice"]:
                raise AssertionError(f"[tune] the auto engine serves "
                                     f"{auto.buckets}, not the tuned ladder")
            mid = engine(sites.ladder_candidates(1024)["pow2_mid"])
            want = served(pow2)
            for name, eng in (("auto", auto), ("pow2_mid", mid)):
                got = served(eng)
                if not np.isfinite(got).all() or \
                        not np.array_equal(got.view(np.int32),
                                           want.view(np.int32)):
                    raise AssertionError(f"[tune] {kind} scores of the "
                                         f"{name} ladder differ from pow2")
            report["scores_equal"][kind] = len(rows)
        tiered = _tiered(torch, cfg.replace(state_layout="tiered"), data,
                         len(names), device)
        if tiered.init_chunk != chunk["choice"]:
            raise AssertionError("[tune] the tiered engine did not read the "
                                 "tuned chunk")
    finally:
        if old_env is None:
            os.environ.pop("FEDMSE_TUNE_CACHE", None)
        else:
            os.environ["FEDMSE_TUNE_CACHE"] = old_env
    hybrid = make_model("hybrid", *DIMS, device="cpu")
    big = 4096 + 1000
    tier = TieredClientStore.create(hybrid, big,
                                    ExperimentRngs(run=0).generator,
                                    init_chunk=chunk["choice"])
    dense = init_client_states(hybrid, big, ExperimentRngs(run=0).generator,
                               device="cpu")
    if not torch.equal(tier.host.params, dense.params):
        raise AssertionError("[tune] the tuned chunk's tier is not the "
                             "dense init's bits")
    shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t0
    log(f"[tune] auto ladder {ladder['choice']} served 8192 rows, centroid "
        f"and kNN, the pow2 engine's bits (pow2_mid too); the tier of "
        f"{big} clients at chunk {chunk['choice']} and the tiered engine's "
        f"init_chunk=None read it: the dense init's bits; done in "
        f"{report['seconds']:.1f} s")
    return report


# ---- the network serving plane (phase "net") ---- #

NET_ROWS = 8192          # (a): interleaved test rows streamed
NET_BURST = 64           # (a): rows per SUBMIT frame
NET_CAP_REPLICAS = (1, 2, 4)  # (c): calibrate_capacity at these fleets
NET_CELL_S = 2.0         # (c): seconds of each open-loop cell
NET_LAUNCHES = {}        # the --serve-net path's kernel launches, by wrapper


def card_memory_mib() -> int:
    """The card's used memory (MiB) as nvidia-smi reads it: every
    process's contexts and allocations, this one's included."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return int(out.stdout.strip().splitlines()[0])


def _bits_equal(got, want) -> bool:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return got.shape == want.shape and np.array_equal(got.view(np.int32),
                                                      want.view(np.int32))


def net_by_hand(torch, device, cfg, data, writer, names, store):
    """(a) The --serve-net plane built by hand on the trained checkpoint (2
    kNN replicas, admission at the measured capacity), 8,192 interleaved
    rows in 64-row bursts over localhost TCP through a NetClient, the
    calibration swapped mid-stream: every row once, and each scored row's
    score the bits of the port's own ServingEngine.score for that row.
    The served plane's launches are counted into `store`; the reference
    engine's, which checks it, are not."""
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.net import (AdmissionController, FrontHandle,
                                      NetClient, NetFront, Router,
                                      make_local_replicas, wire)
    from fedmse_tpu_torch.serving import (ServingEngine, fit_calibration,
                                          interleave_test_rows)
    from fedmse_tpu_torch.serving.smoke import _host
    model = make_model("hybrid", *DIMS, device=device)

    def engine():
        return ServingEngine.from_checkpoint(
            writer, model, "hybrid", "mse_avg", names, train_x=data.train_xb,
            train_m=data.train_mb, max_bucket=cfg.serve_max_batch,
            score_kind="knn", device=device, **KNN)

    rows, gws, _ = interleave_test_rows(
        _host(data.test_x), _host(data.test_m), _host(data.test_y), NET_ROWS)
    with counted_launches(store):
        engines = [engine() for _ in range(cfg.net_replicas)]
        calib = fit_calibration(engines[0], _host(data.valid_x),
                                _host(data.valid_m))
        router = Router(make_local_replicas(
            lambda i: engines[i], len(engines),
            max_batch=cfg.serve_max_batch,
            latency_budget_ms=cfg.serve_latency_budget_ms,
            calibration=calib),
            admission=AdmissionController(tiers=cfg.net_tiers,
                                          headroom=cfg.net_shed_headroom))
        capacity = router.calibrate_capacity(rows, gws)
        handle = FrontHandle(NetFront(router))
        client = None
        try:
            client = NetClient("127.0.0.1", handle.port, timeout_s=60.0)
            rids, event = [], None
            for s in range(0, len(rows), NET_BURST):
                rids.append(client.submit(rows[s:s + NET_BURST],
                                          gws[s:s + NET_BURST]))
                client.poll()
                if event is None and s >= len(rows) // 2:
                    event = client.swap({"calibration": calib})
            client.wait_all(timeout_s=60.0)
            stats = client.stats()
        finally:
            if client is not None:
                client.close()
            handle.stop()
    statuses = np.concatenate([client.results[r][0] for r in rids])
    scores = np.concatenate([client.results[r][1] for r in rids])
    want = engine().score(rows, gws)
    verdicts = np.where(calib.verdicts(want, gws), wire.STATUS_ANOMALY,
                        wire.STATUS_NORMAL)
    lat = client.latencies_s() * 1e3
    out = {"rows": len(rows), "requests": len(rids),
           "capacity_rows_per_sec": capacity,
           "swap_kinds": event["kinds"], "swap_replicas": event["replicas"],
           "statuses": client.status_counts(),
           "rows_served": stats["router"]["rows_served"],
           "scores_engine_bits": _bits_equal(scores, want),
           "statuses_equal_verdicts": bool(np.array_equal(statuses,
                                                          verdicts)),
           "request_p50_ms": float(np.percentile(lat, 50)),
           "request_p99_ms": float(np.percentile(lat, 99))}
    if not (out["scores_engine_bits"] and out["statuses_equal_verdicts"]
            and out["rows_served"] == len(rows)
            and sum(out["statuses"].values()) == len(rows)
            and event["replicas"] == len(engines)
            and np.isfinite(scores).all()):
        raise AssertionError(f"[net] (a) by hand: {json.dumps(out)}")
    return out


def net_serve_pass(torch, device, cfg, data, names, store):
    """(a) The --serve-net path: the quick-run sweep's hybrid / mse_avg
    combination (the driver's run_combination, checkpoints saved), then
    its network pass (net.run_net_smoke) with the kNN score, 2 replicas
    and 8,192 rows in 64-row bursts; then the same plane by hand. Their
    launches are counted into `store`, the by-hand check's reference
    scoring's not."""
    from fedmse_tpu_torch.checkpointing import ResultsWriter
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.net import run_net_smoke
    c = cfg.replace(score_kind="knn", net_replicas=2, **KNN)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_net_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    writer = ResultsWriter(ckpt, c.network_size, "chip-smoke-net",
                           c.scen_name, c.metric, c.num_participants)
    with counted_launches(store):
        t0 = time.perf_counter()
        trained = run_combination(c, data, len(names), "hybrid", "mse_avg",
                                  0, writer=writer, device_names=names,
                                  save_checkpoints=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = run_net_smoke(c, data, len(names), writer, names, "hybrid",
                            "mse_avg", run=0, max_rows=NET_ROWS,
                            burst=NET_BURST)
        smoke_s = time.perf_counter() - t0
    counts = rep["statuses"]
    if not (rep["zero_dropped"] and rep["swap_broadcast"]
            and rep["rows_streamed"] == min(NET_ROWS,
                                            int(data.test_m.sum()))
            and sum(counts.values()) == rep["rows_streamed"]
            and counts["shed"] == 0 and counts["unknown_gateway"] == 0
            and rep["router"]["rows_served"] == rep["rows_streamed"]
            and rep["score_kind"] == "knn" and rep["replicas"] == 2):
        raise AssertionError(f"[net] (a) run_net_smoke: {json.dumps(rep)}")
    by_hand = net_by_hand(torch, device, c, data, writer, names, store)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"train_seconds": train_s,
            "final_mean_auc": float(np.mean(trained["final_metrics"])),
            "smoke_seconds": smoke_s,
            "smoke": {k: rep[k] for k in (
                "rows_streamed", "statuses", "zero_dropped",
                "swap_broadcast", "capacity_rows_per_sec", "request_p50_ms",
                "request_p99_ms")},
            "by_hand": by_hand}


def net_worker(torch, device, smi):
    """(b) A replica worker process on the same card (`python -m
    fedmse_tpu_torch.net.server --replicas 1 --no-admission --seed 0`,
    spawned, never forked, after this process built the kernels) behind
    a RemoteReplica, striped with a LocalReplica of
    build_synthetic_replicas(seed=0): the worker's scores are the local
    replica's bits; a params swap reaches it (swap_count 1); it exits 0
    on SIGTERM. The card's used memory before, with and after it."""
    import select
    import signal
    from fedmse_tpu_torch.net import RemoteReplica, Router
    from fedmse_tpu_torch.net.server import build_synthetic_replicas
    torch.cuda.synchronize()
    mem = {"before_mib": card_memory_mib()}
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedmse_tpu_torch.net.server", "--replicas",
         "1", "--no-admission", "--seed", "0", "--dim", str(DIMS[0]),
         "--device", device.type], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    remote = None
    try:
        t0 = time.perf_counter()
        ready, _, _ = select.select([proc.stdout], [], [], 300.0)
        if not ready:
            raise AssertionError("[net] (b) the worker printed no listening "
                                 "line in 300 s")
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"[net] (b) the worker exited "
                                 f"{proc.wait(30)}: {proc.stderr.read()}")
        info = json.loads(line)
        start_s = time.perf_counter() - t0
        mem["with_worker_mib"] = card_memory_mib()
        local = build_synthetic_replicas(dim=DIMS[0], seed=0, replicas=1,
                                         device=device)[0]
        remote = RemoteReplica("127.0.0.1", info["port"], num_gateways=10,
                               max_batch=1024, timeout_s=60.0)
        rng = np.random.default_rng(SEED + 40)
        rows = rng.normal(size=(8192, DIMS[0])).astype(np.float32)
        gws = rng.integers(0, 10, len(rows)).astype(np.int32)
        want = local.engine.score(rows, gws)
        blocks = [remote.submit_many(rows[s:s + 1024], gws[s:s + 1024])
                  for s in range(0, len(rows), 1024)]
        remote.drain()
        worker_bits = _bits_equal(np.concatenate([b.scores for b in blocks]),
                                  want)
        router = Router([local, remote])
        res = router.submit_many(rows, gws)
        router.drain()
        res.finalize()
        striped_bits = _bits_equal(res.scores, want)
        router.swap(params=local.engine.params)
        swap_count = remote.stats()["router"]["per_replica"][0]["swap_count"]
        res = router.submit_many(rows[:2048], gws[:2048])
        router.drain()
        res.finalize()
        after_swap_bits = _bits_equal(res.scores, want[:2048])
        remote.close()
        remote = None
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        torch.cuda.synchronize()
        mem["after_exit_mib"] = card_memory_mib()
    finally:
        if remote is not None:
            remote.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)
    out = {"worker_start_seconds": start_s, "card_memory": mem,
           "worker_scores_local_bits": worker_bits,
           "striped_scores_local_bits": striped_bits,
           "worker_swap_count": swap_count,
           "after_swap_bits": after_swap_bits,
           "worker_exit_code": proc.returncode}
    log(f"[net] (b) worker process on the same card ({smi}): "
        f"{json.dumps(out)}")
    if not (worker_bits and striped_bits and after_swap_bits
            and swap_count == 1 and proc.returncode == 0):
        raise AssertionError(f"[net] (b) worker: {json.dumps(out)}; "
                             f"stderr {err[-2000:]}")
    return out


def _open_loop(port, rate, seconds, rows, gws, tiers, burst=1024):
    """One open-loop NetClient stream: a `burst`-row SUBMIT every
    burst/rate seconds (as fast as it can send when behind, never waiting
    for results), for `seconds`; then every result. Returns the
    client-side accounting: rows by status and by tier, rows/s served,
    request p50/p99."""
    from fedmse_tpu_torch.net import NetClient, wire
    client = NetClient("127.0.0.1", port, timeout_s=120.0)
    try:
        t0 = time.perf_counter()
        k = 0
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if rate is not None and now < t0 + k * burst / rate:
                client.poll()
                time.sleep(min(t0 + k * burst / rate - now, 2e-4))
                continue
            s = (k * burst) % (len(rows) - burst + 1)
            client.submit(rows[s:s + burst], gws[s:s + burst],
                          tiers[:burst])
            client.poll()
            k += 1
        sent_s = time.perf_counter() - t0
        client.wait_all(timeout_s=120.0)
        wall = time.perf_counter() - t0
    finally:
        client.close()
    shed_by_tier = np.zeros(3, np.int64)
    for st, _, _ in client.results.values():
        np.add.at(shed_by_tier, tiers[:burst][st == wire.STATUS_SHED], 1)
    counts = client.status_counts()
    lat = client.latencies_s() * 1e3
    return {"offered_rows_per_sec": client.rows_submitted / sent_s,
            "rows_submitted": client.rows_submitted, "statuses": counts,
            "shed_by_tier": shed_by_tier.tolist(),
            "served_rows_per_sec": (counts["normal"] + counts["anomaly"])
            / wall,
            "request_p50_ms": float(np.percentile(lat, 50)),
            "request_p99_ms": float(np.percentile(lat, 99)),
            "exactly_once": sum(counts.values()) == client.rows_submitted}


def net_capacity(torch, device, smi):
    """(c) calibrate_capacity at 1, 2 and 4 local replicas (10 gateways,
    max_batch 1024, each replica on its own stream); then a 2-replica
    plane behind a NetFront (3 tiers, headroom 0.9, the 25 ms staleness
    gate): a tier-0 stream as fast as one client sends measures what the
    socket path sustains, the admission capacity is set to the smaller of
    that and the probe, and open-loop streams of 1024-row bursts (tiers
    0, 1, 2 in turn) run at 0.5x and 2x it: the bucket sheds nothing at
    0.5x; at 2x rows shed, tier 0 never, the lowest tier most. What the
    staleness gate sheds at 0.5x (bursts that queued past their tier's
    limit, which a host that other work slows produces at any load) is
    watched against 0, as the cell's p99 is, and not asserted."""
    from fedmse_tpu_torch.net import (AdmissionController, FrontHandle,
                                      NetFront, Router)
    from fedmse_tpu_torch.net.server import build_synthetic_replicas
    reps = build_synthetic_replicas(n_gateways=10, dim=DIMS[0], replicas=4,
                                    max_batch=1024, seed=SEED, device=device)
    rng = np.random.default_rng(SEED + 41)
    probe = rng.normal(size=(1024, DIMS[0])).astype(np.float32)
    probe_g = rng.integers(0, 10, 1024).astype(np.int32)
    caps = {n: Router(reps[:n]).calibrate_capacity(probe, probe_g)
            for n in NET_CAP_REPLICAS}
    log(f"[net] (c) calibrate_capacity ({smi}): "
        + ", ".join(f"{n} replica(s) {caps[n]:.1f} rows/s"
                    for n in NET_CAP_REPLICAS))
    rows = rng.normal(size=(32 * 1024, DIMS[0])).astype(np.float32)
    gws = rng.integers(0, 10, len(rows)).astype(np.int32)
    tiers = (np.arange(1024) % 3).astype(np.uint8)
    admission = AdmissionController(tiers=3, headroom=0.9,
                                    stale_after_s=0.025)
    router = Router(reps[:2], admission=admission)
    handle = FrontHandle(NetFront(router))
    cells = {}
    gc.collect()
    gc.freeze()
    try:
        cells["saturation"] = _open_loop(handle.port, None, 1.0, rows, gws,
                                         np.zeros(1024, np.uint8))
        sustained = cells["saturation"]["served_rows_per_sec"]
        capacity = min(caps[2], sustained)
        for name, x in (("half", 0.5), ("double", 2.0)):
            admission.set_capacity(capacity)
            stale = admission.stale_shed.copy()
            cells[name] = _open_loop(handle.port, x * capacity, NET_CELL_S,
                                     rows, gws, tiers)
            cells[name]["stale_shed_by_tier"] = (admission.stale_shed
                                                 - stale).tolist()
    finally:
        gc.unfreeze()
        handle.stop()
    out = {"capacity_rows_per_sec": {str(n): caps[n]
                                     for n in NET_CAP_REPLICAS},
           "sustained_rows_per_sec": sustained,
           "admission_capacity_rows_per_sec": capacity, "cells": cells}
    for name, cell in cells.items():
        log(f"[net] (c) {name}: {json.dumps(cell)}")
    watched("rows/s served over TCP, 2 replicas, one client at saturation",
            sustained, 100_000.0, True)
    watched("request p99 ms over TCP at 0.5x capacity",
            cells["half"]["request_p99_ms"], 25.0, False)
    half, double = cells["half"], cells["double"]
    watched("rows shed by the staleness gate over TCP at 0.5x capacity",
            sum(half["stale_shed_by_tier"]), 0.0, False)
    shed = double["shed_by_tier"]
    if not (all(c["exactly_once"] for c in cells.values())
            and cells["saturation"]["statuses"]["shed"] == 0
            and half["shed_by_tier"] == half["stale_shed_by_tier"]
            and half["shed_by_tier"][0] == 0
            and double["statuses"]["shed"] > 0 and shed[0] == 0
            and shed[2] >= shed[1]):
        raise AssertionError(f"[net] (c) shedding: {json.dumps(out)}")
    return out


def phase_net(torch, device, cfg, data, names, smi):
    """The network serving plane (--serve-net, net/) on the card: first
    the kernels at the plane's shapes against their plain versions (10
    routed models, every bucket rung to --serve-net's 256 rows and the
    capacity fleet's 1,024; the kNN buckets' distances to 10 banks); (a)
    the --serve-net path, launch counters set to 0 before and read after
    each of its parts (the quick-run sweep that trains the checkpoint and
    run_net_smoke; the served plane by hand, not its reference); (b) a
    replica worker process on the same card; (c) capacity at 1, 2 and 4
    replicas, and shedding at 0.5x and 2x."""
    t0 = time.perf_counter()
    report = {"kernels_vs_plain": routed_kernel_shapes(
        torch, device, "net", 10,
        [(r, "random") for r in (1, 2, 3, 4, 8, 16, 32, 48, 64, 128, 200,
                                 256, 512, 1024)],
        dist_rows=(1, 7, 64, 256, 1024))}
    log(f"[net] kernels at the plane's shapes agree with their plain "
        f"versions and with a second call: "
        f"{json.dumps(report['kernels_vs_plain'])}")
    NET_LAUNCHES.clear()
    report["a"] = net_serve_pass(torch, device, cfg, data, names,
                                 NET_LAUNCHES)
    report["launches"] = dict(NET_LAUNCHES)
    for name, k in report["launches"].items():
        if k < 1:
            raise AssertionError(f"the --serve-net path never launched "
                                 f"{name}")
    a = report["a"]
    log(f"[net] (a) --serve-net path launches "
        f"{json.dumps(report['launches'])}; run_net_smoke "
        f"{json.dumps(a['smoke'])}; by hand {json.dumps(a['by_hand'])}")
    watched("request p99 ms, run_net_smoke (kNN, 2 replicas, bursts of 64)",
            a["smoke"]["request_p99_ms"], 25.0, False)
    report["b"] = net_worker(torch, device, smi)
    report["c"] = net_capacity(torch, device, smi)
    report["seconds"] = time.perf_counter() - t0
    log(f"[net] done in {report['seconds']:.1f} s ({smi})")
    return report


# ---- the gateway ingest plane (phase "gateway") ---- #

GATEWAY_FLEET = dict(n_gateways=1024, dim=DIMS[0], replicas=2)
GATEWAY_CONNS = 16
GATEWAY_BURST = 64
GATEWAY_LAUNCHES = {}    # the gateway path's kernel launches, by wrapper


def _wait_reject(client, code, seconds=30.0):
    deadline = time.perf_counter() + seconds
    while not any(c == code for _, c, _ in client.rejects):
        if time.perf_counter() > deadline:
            raise AssertionError(f"[gateway] no reject {code} in {seconds} s")
        client.poll()
        time.sleep(0.002)


def gateway_sessions(torch, device, smi, bursts, want):
    """(a), (c) build_synthetic_frontend at 1,024 gateways (115/27/7,
    hybrid, 2 replicas, admission + isolation) behind a FrontendHandle;
    first an unknown gateway, a bad MAC and a bad token, each rejected
    with rows_parsed 0; then 1,024 sessions over 16 connections, one
    64-row burst each, all sent at once (the flood), and again paced
    open-loop at half the flood's rows/s: every verdict and score the
    direct router's bits. Handshakes/s, the flood's rows/s and its
    frontend and client threads' CPU seconds over its wall, and the paced
    stream's request p99."""
    from fedmse_tpu_torch.gateway import (FrontendHandle, GatewayClient,
                                          auth, build_synthetic_frontend,
                                          mux)
    t0 = time.perf_counter()
    front = build_synthetic_frontend(seed=SEED, device=device,
                                     **GATEWAY_FLEET)
    build_s = time.perf_counter() - t0
    n = GATEWAY_FLEET["n_gateways"]
    master = auth.master_key(seed=SEED)
    handle = FrontendHandle(front)
    clients = []
    try:
        probe = GatewayClient("127.0.0.1", handle.port, master=master,
                              timeout_s=60.0)
        clients.append(probe)
        bad_key = GatewayClient("127.0.0.1", handle.port, timeout_s=60.0,
                                key_fn=lambda g, gen: b"\x00" * 32)
        clients.append(bad_key)
        rejected = [not probe.authenticate(n + 5),
                    not bad_key.authenticate(7)]
        if not probe.authenticate(0):
            raise AssertionError("[gateway] gateway 0 not welcomed")
        probe._send(mux.pack_submit(0, 1, b"\x00" * mux.TOKEN_LEN,
                                    bursts[0]))
        _wait_reject(probe, mux.REJ_BAD_TOKEN)
        rejects = dict(front.rejects)
        parsed_after_rejects = front.rows_parsed
        per = n // GATEWAY_CONNS
        conns = [GatewayClient("127.0.0.1", handle.port, master=master,
                               timeout_s=60.0) for _ in range(GATEWAY_CONNS)]
        clients += conns
        t0 = time.perf_counter()
        welcomed = sum(c.authenticate_many(range(j * per, (j + 1) * per))
                       for j, c in enumerate(conns))
        hs_s = time.perf_counter() - t0
        front_clock = time.pthread_getcpuclockid(handle._thread.ident)
        cpu0 = (time.clock_gettime(front_clock), time.thread_time())
        t0 = time.perf_counter()
        seqs = {}
        for j, c in enumerate(conns):
            for g in range(j * per, (j + 1) * per):
                seqs[g] = c.submit(g, bursts[g])
        for c in conns:
            c.wait_all(timeout_s=120.0)
        rows_s = time.perf_counter() - t0
        cpu_s = (time.clock_gettime(front_clock) - cpu0[0],
                 time.thread_time() - cpu0[1])
        # the same bursts paced: one every 64 / rate seconds, round robin
        # over the sessions, never waiting for a result
        rate = 0.5 * n * GATEWAY_BURST / rows_s
        paced = {}
        t0 = time.perf_counter()
        for g in range(n):
            while time.perf_counter() < t0 + g * GATEWAY_BURST / rate:
                for c in conns:
                    c.poll()
            paced[g] = conns[g // per].submit(g, bursts[g])
        for c in conns:
            c.wait_all(timeout_s=120.0)
        stats = front.stats()
    finally:
        for c in clients:
            c.close()
        handle.stop()
    got_st = np.concatenate([conns[g // per].results[(g, seqs[g])][0]
                             for g in range(n)])
    got_sc = np.concatenate([conns[g // per].results[(g, seqs[g])][1]
                             for g in range(n)])
    lat = np.asarray([conns[g // per].results[(g, seqs[g])][2]
                      for g in range(n)]) * 1e3
    paced_res = [conns[g // per].results[(g, paced[g])] for g in range(n)]
    paced_lat = np.asarray([r[2] for r in paced_res]) * 1e3
    out = {"build_seconds": build_s, "sessions": welcomed,
           "connections": GATEWAY_CONNS,
           "rejects": rejects, "rows_parsed_after_rejects":
           parsed_after_rejects, "rejected": rejected,
           "handshakes_per_sec": welcomed / hs_s,
           "rows": int(got_st.size), "rows_per_sec": got_st.size / rows_s,
           "frontend_thread_cpu_share": cpu_s[0] / rows_s,
           "client_thread_cpu_share": cpu_s[1] / rows_s,
           "request_p50_ms": float(np.percentile(lat, 50)),
           "request_p99_ms": float(np.percentile(lat, 99)),
           "paced_rows_per_sec": rate,
           "paced_request_p50_ms": float(np.percentile(paced_lat, 50)),
           "paced_request_p99_ms": float(np.percentile(paced_lat, 99)),
           "statuses_equal_direct": bool(np.array_equal(got_st, want[0])),
           "scores_direct_bits": _bits_equal(got_sc, want[1]),
           "paced_statuses_equal_direct": bool(np.array_equal(
               np.concatenate([r[0] for r in paced_res]), want[0])),
           "paced_scores_direct_bits": _bits_equal(
               np.concatenate([r[1] for r in paced_res]), want[1]),
           "rows_parsed": stats["rows_parsed"],
           "sessions_table": stats["sessions"]}
    log(f"[gateway] (a) {json.dumps(out)}")
    if not (all(rejected) and rejects.get("unknown_gateway") == 1
            and rejects.get("bad_mac") == 1 and rejects.get("bad_token") == 1
            and parsed_after_rejects == 0 and welcomed == n
            and out["statuses_equal_direct"] and out["scores_direct_bits"]
            and out["paced_statuses_equal_direct"]
            and out["paced_scores_direct_bits"]
            and stats["rows_parsed"] == 2 * n * GATEWAY_BURST):
        raise AssertionError(f"[gateway] (a) {json.dumps(out)}")
    watched("gateway handshakes/s (1,024 sessions over 16 connections)",
            out["handshakes_per_sec"], 3000.0, True)
    watched("rows/s through the gateway frontend (64-row bursts)",
            out["rows_per_sec"], 100_000.0, True)
    watched("gateway request p99 ms (64-row bursts paced at half the "
            "flood's rows/s; 2x the 25 ms batching budget)",
            out["paced_request_p99_ms"], 50.0, False)
    return out


def gateway_failover(torch, device):
    """(b) A FailoverStripe over two replicas of the 1,024-gateway fleet:
    the first dies with pieces in flight, and every admitted row still
    gets its score, the survivor's bits (tests/test_gateway.py's hold at
    the paper's width)."""
    from fedmse_tpu_torch.gateway import FailoverStripe
    from fedmse_tpu_torch.net.server import build_synthetic_replicas
    reps = build_synthetic_replicas(seed=SEED + 1, max_batch=256,
                                    device=device, **GATEWAY_FLEET)

    class Dying:
        def __init__(self, inner):
            self.inner = inner
            self.dead = False

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def poll(self):
            if self.dead:
                raise RuntimeError("replica killed mid-flight")
            return self.inner.poll()

    dying = Dying(reps[0])
    stripe = FailoverStripe([dying, reps[1]])
    rng = np.random.default_rng(SEED + 42)
    rows = rng.normal(size=(4096, DIMS[0])).astype(np.float32)
    gws = rng.integers(0, GATEWAY_FLEET["n_gateways"], len(rows)).astype(
        np.int32)
    blk = stripe.submit_many(rows, gws)
    dying.dead = True
    deadline = time.perf_counter() + 60
    while not blk.done:
        stripe.poll()
        if time.perf_counter() > deadline:
            raise AssertionError("[gateway] (b) the stripe stalled")
    st = stripe.stats()
    out = {"failover_events": len(st["failover_events"]),
           "alive": st["alive"], "rows_resubmitted": st["rows_resubmitted"],
           "rows": len(blk.scores),
           "survivor_bits": _bits_equal(blk.scores,
                                        reps[1].engine.score(rows, gws))}
    log(f"[gateway] (b) failover: {json.dumps(out)}")
    if not (out["failover_events"] >= 1 and out["alive"] == 1
            and out["rows_resubmitted"] > 0 and out["survivor_bits"]):
        raise AssertionError(f"[gateway] (b) {json.dumps(out)}")
    return out


def phase_gateway(torch, device, smi):
    """The gateway ingest plane (gateway/) on the card: first the forward
    at the plane's shapes against its plain version (1,024 routed models:
    random and 64-row-session buckets up to 1,024 rows, and the engines'
    fit over 512 train rows a gateway); (a) and (c) through
    build_synthetic_frontend at 1,024 gateways, launch counters set to 0
    before and read after (the gateway path); (b) failover."""
    from fedmse_tpu_torch.net import Router
    from fedmse_tpu_torch.net.server import build_synthetic_replicas
    t0 = time.perf_counter()
    n = GATEWAY_FLEET["n_gateways"]
    rng = np.random.default_rng(SEED + 43)
    bursts = rng.normal(size=(n, GATEWAY_BURST, DIMS[0])).astype(np.float32)
    # the direct router over the same seeded fleet: the verdicts to match
    direct = Router(build_synthetic_replicas(seed=SEED, device=device,
                                             **GATEWAY_FLEET))
    results = [direct.submit_many(bursts[g], np.int32(g)) for g in range(n)]
    direct.drain()
    if not all(r.finalize() for r in results):
        raise AssertionError("[gateway] the direct router left rows open")
    want = (np.concatenate([r.statuses for r in results]),
            np.concatenate([r.scores for r in results]))
    del direct
    report = {"kernels_vs_plain": routed_kernel_shapes(
        torch, device, "gateway", n,
        [(1, "random"), (64, "random"), (64, "sessions"), (256, "random"),
         (1024, "random"), (1024, "sessions"), (n * 512, "client_major")])}
    log(f"[gateway] the forward at the plane's shapes agrees with its plain "
        f"version and with a second call: "
        f"{json.dumps(report['kernels_vs_plain'])}")
    GATEWAY_LAUNCHES.clear()
    with counted_launches(GATEWAY_LAUNCHES):
        report["a"] = gateway_sessions(torch, device, smi, bursts, want)
    report["launches"] = dict(GATEWAY_LAUNCHES)
    if report["launches"]["fused_ae_forward"] < 1:
        raise AssertionError("the gateway path never launched the forward")
    log(f"[gateway] gateway path launches "
        f"{json.dumps(report['launches'])}")
    report["b"] = gateway_failover(torch, device)
    report["seconds"] = time.perf_counter() - t0
    log(f"[gateway] done in {report['seconds']:.1f} s ({smi})")
    return report


# ---- the client mesh (phase "parallel") ---- #

PARALLEL_WORLD = 2             # (b)-(d): gloo ranks on the one card
PARALLEL_TIER_N = 10_000       # (c): bulk gateways
PARALLEL_TIER_COHORT = 512     # (c): C
PARALLEL_BLOCK = 256           # the quantized merge's block (the default)
PARALLEL_LAUNCHES = {}         # the parallel path's launches, by wrapper
PARALLEL_JOB = "chip_smoke:parallel_rank"  # (b)-(e)'s rank job


def parallel_quick(torch, cfg, n=10, tie_break=False):
    """The quick run's config at `n` gateways with the vote's tie-break off
    (or on), and the `n` gateways stacked on the host (the main path's
    sizes, drawn again; at n = 10 its clients)."""
    import dataclasses
    from fedmse_tpu_torch.data import (build_dev_dataset, stack_clients,
                                       synthetic_clients)
    qc = cfg.replace(network_size=n, compat=dataclasses.replace(
        cfg.compat, vote_tie_break=tie_break))
    clients = synthetic_clients(n_clients=n, dim=DIMS[0], n_normal=10_000,
                                n_abnormal=2_000, seed=SEED)
    dev_x = build_dev_dataset(clients, np.random.default_rng(qc.data_seed))
    return qc, stack_clients(clients, dev_x, qc.batch_size, device="cpu")


def mesh_quick_run(torch, cfg, data, mesh, device):
    """hybrid / mse_avg through the fused engine over `mesh` (None or one
    rank: the plain engine, its data on `device`): round 1 alone, then
    the others in one chunk. Returns (report, engine)."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    n = int(data.client_mask.sum())
    if mesh is None or not mesh.sharded:
        data = _federation_rows(data, data.client_mask.shape[0], device)
    eng = RoundEngine(make_model("hybrid", *DIMS, cfg.shrink_lambda,
                                 device=device), cfg, data, n,
                      ExperimentRngs(run=0), "hybrid", "mse_avg", fused=True,
                      mesh=mesh)
    t0 = time.perf_counter()
    res = eng.run_rounds(0, 1)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    p1 = eng.gathered_states().params.numpy()
    t1 = time.perf_counter()
    res += eng.run_rounds(1, cfg.num_rounds - 1)
    torch.cuda.synchronize()
    walls = time.perf_counter() - t1
    final = eng.evaluate()
    return {"selected": [r.selected for r in res],
            "aggregators": [r.aggregator for r in res],
            "metrics": [r.client_metrics for r in res],
            "backend": [r.backend for r in res],
            "params1": p1, "params": eng.gathered_states().params.numpy(),
            "final": final, "auc": float(np.nanmean(final)),
            "round1_s": wall1,
            "steady_round_s": walls / max(cfg.num_rounds - 1, 1),
            "graphs": eng._fused.stats()["graphs"]}, eng


def phase_quick_config(cfg):
    """(e)'s config: the quick run's, merged by shard_map and scored by
    kNN (so that the per-phase round's evaluation launches the distance
    kernel)."""
    return cfg.replace(aggregation_backend="shard_map", score_kind="knn",
                       **KNN)


def mesh_phase_run(torch, cfg, data, mesh, device):
    """(e) hybrid / mse_avg through the per-phase engine with profile=True
    over `mesh` (None: the dense engine, its data on `device`), round by
    round. Returns (report, engine): each round's wall (the card
    synchronized) and phase seconds."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    n = int(data.client_mask.sum())
    if mesh is None:
        data = _federation_rows(data, data.client_mask.shape[0], device)
    eng = RoundEngine(make_model("hybrid", *DIMS, cfg.shrink_lambda,
                                 device=device), cfg, data, n,
                      ExperimentRngs(run=0), "hybrid", "mse_avg",
                      fused=False, profile=True, mesh=mesh)
    res, walls, p1 = [], [], None
    for r in range(cfg.num_rounds):
        t0 = time.perf_counter()
        res.append(eng.run_round(r))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r == 0:
            p1 = eng.gathered_states().params.numpy()
    final = eng.evaluate()
    return {"selected": [r.selected for r in res],
            "aggregators": [r.aggregator for r in res],
            "backend": [r.backend for r in res],
            "phase_seconds": [r.phase_seconds for r in res],
            "round_s": walls, "params1": p1,
            "params": eng.gathered_states().params.numpy(),
            "final": final, "auc": float(np.nanmean(final))}, eng


def quantized_vs_exact(torch, eng, mesh, block):
    """The quantized merge (one group a rank) against the exact one on an
    engine's states, every client weighted: (max |error|, the codec bound
    summed over the ranks' partials)."""
    from fedmse_tpu_torch.parallel import collectives as coll
    from fedmse_tpu_torch.parallel.quantize import quantization_error_bound
    model, d = eng.model, eng.data
    p, sel = eng.states.params, d.client_mask
    exact, w = coll.make_shardmap_aggregate(model, "mse_avg", mesh)(
        p, sel, d.dev_x)
    q, _ = coll.make_hierarchical_aggregate(
        model, "mse_avg", mesh, num_groups=mesh.world_size,
        block_size=block)(p, sel, d.dev_x)
    parts = mesh.gather_host((w @ p).cpu().numpy())
    bound = sum(quantization_error_bound(part, block) for part in parts)
    return float((q - exact).abs().max()), float(bound)


def mesh_tier(torch, cfg, mesh, device, n, cohort, host_sharded,
              selections=None):
    """(c) n bulk gateways, 2 rounds at cohort C: through
    run_tiered_combination, or with `selections` one process's tier
    replaying a run's selections round by round (the host-sharded draw is
    stratified by rank block, so a one-process run draws other
    cohorts)."""
    from fedmse_tpu_torch.federation.tiered import (TieredRoundEngine,
                                                    run_tiered_combination)
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    bulk = bulk_federation(torch, n, DIMS[0], cfg.batch_size, SEED + 50)
    tc = cfg.replace(num_participants=(cohort + 0.5) / n, num_rounds=2,
                     state_layout="tiered", host_sharded=host_sharded)
    t0 = time.perf_counter()
    if selections is None:
        out = run_tiered_combination(tc, bulk, n, "hybrid", "mse_avg", 0,
                                     mesh=mesh, device=device)
        eng, rounds, final = (out["engine"], out["rounds"],
                              out["final_metrics"])
    else:
        eng = TieredRoundEngine(make_model("hybrid", *DIMS, device=device),
                                tc, bulk, n, ExperimentRngs(run=0),
                                "hybrid", "mse_avg", device=device)
        rounds = [eng.run_round(r, selected=sel)
                  for r, sel in enumerate(selections)]
        final = eng.evaluate_final_streamed()
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "aggregators": [r.aggregator for r in rounds],
            "selected": [list(r.selected) for r in rounds],
            "final": np.asarray(final),
            "auc": float(np.nanmean(final)),
            "rows": (eng.shard_start, eng.shard_stop),
            "cohort": eng.cohort, "host_state_bytes": eng.store.host_bytes(),
            "host_data_bytes": sum(t.numel() * t.element_size()
                                   for t in eng.host_data.values())}


def mesh_serving(torch, cfg, params, data, mesh, device, launches):
    """(d) the 10 gateways' kNN-scored engine, gateway-sharded over the
    mesh, against the unsharded engine on the same card: 8,192
    interleaved test rows, bits. Only the meshed engine's build and
    scoring count in `launches`."""
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.serving import ServingEngine
    model = make_model("hybrid", *DIMS, cfg.shrink_lambda, device=device)
    tree = ParamLayout(*DIMS).tree(torch.from_numpy(params[:10]))
    xb, mb = data.train_xb[:10].to(device), data.train_mb[:10].to(device)
    kw = dict(score_kind="knn", knn_bank_size=KNN["knn_bank_size"],
              knn_k=KNN["knn_k"], device=device)
    t = data.test_x.shape[1]
    rows = data.test_x[:10].transpose(0, 1).reshape(-1, DIMS[0])[:8192]
    gws = np.tile(np.arange(10, dtype=np.int32), t)[:8192]
    with counted_launches(launches):
        meshed = ServingEngine.from_federation(model, "hybrid", tree, xb, mb,
                                               mesh=mesh, **kw)
        got = meshed.score(rows.numpy(), gws)
    plain = ServingEngine.from_federation(model, "hybrid", tree, xb, mb,
                                          **kw)
    want = plain.score(rows.numpy(), gws)
    return {"rows": len(gws), "gateway_sharded": meshed.gateway_sharded,
            "bucket": meshed.max_bucket, "bits": _bits_equal(got, want)}


def mesh_kernel_shapes(torch, device, cfg, eng, bucket, tag="parallel"):
    """Each kernel at one rank's own shapes on the 2-rank path against its
    plain version, f32 on dyadic grids, each also bit-equal to a second
    call: the train step over the rank's block of G clients (batches of
    the run's size, one client masked whole as an unselected one is, one
    batch short of full), the forward client-major over the block's
    validation (and vote) rows, dev rows (the mse_avg weights), test rows
    and train rows (the kNN evaluation's and the meshed engine's bank
    fit), and routed over one meshed serving bucket of `bucket` rows; the
    distances of that bucket to the block's G banks, and of the block's
    test rows client-major (the per-phase round's kNN evaluation).
    `tag` names the phase in a failure."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    d = eng.data
    g, b = d.train_xb.shape[0], d.train_xb.shape[2]
    layout = ParamLayout(*DIMS)
    kw = dict(layout=layout, shrink_lambda=cfg.shrink_lambda)
    gen = torch.Generator().manual_seed(SEED + 60)
    flat, xt = grid_inputs(torch, layout, g, 4 * b, gen, device)
    m = torch.ones((g, 4 * b), device=device)
    m[0] = 0.0  # an unselected client
    m[-1, -5:] = 0.0

    def err_nan(a, c):  # the masked client's loss and grads are NaN
        if not torch.equal(a.isnan(), c.isnan()):
            return float("inf")
        return scaled_err(a[~a.isnan()], c[~c.isnan()])

    err = 0.0
    for k in range(4):
        x = xt[:, k * b:(k + 1) * b].contiguous()
        mb = m[:, k * b:(k + 1) * b].contiguous()
        got = fused_train_grads(flat, x, mb, **kw)
        again = fused_train_grads(flat, x, mb, **kw)
        if not all(torch.equal(a.nan_to_num(), c.nan_to_num())
                   for a, c in zip(got, again)):
            raise AssertionError(f"[{tag}] train step, batch {k}: not "
                                 "bit-equal to a second call")
        err = max(err, max(err_nan(a, c) for a, c in zip(
            got, fused_train_grads_plain(flat, x, mb, **kw))))
    worst = {f"train step, G = {g}, 4 batches of {b}": err}
    if not err <= TOL["f32"]:
        raise AssertionError(f"[{tag}] train step vs plain: {err:.3e}")
    per = lambda t: int(np.prod(t.shape[1:-1]))  # rows a client
    worst.update(routed_kernel_shapes(
        torch, device, tag, g,
        [(g * per(d.valid_xb), "client_major"),
         (g * d.dev_x.shape[0], "client_major"),
         (g * per(d.test_x), "client_major"),
         (g * per(d.train_xb), "client_major"), (bucket, "random")],
        dist_rows=(bucket, (g * per(d.test_x), "client_major"))))
    return worst


def parallel_rank(mesh, tier_n, cohort, block):
    """(b)-(e) on one rank of the 2-rank gloo launch on the one card (the
    rank entry: fedmse_tpu_torch/parallel/launch.py). Each rank counts
    its own launches per part (the meshed runs only), then holds each
    kernel to its plain version at the rank's own shapes."""
    import torch
    from fedmse_tpu_torch.config import ExperimentConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.device
    cfg, data = parallel_quick(torch, ExperimentConfig())
    out, launches = {"rank": mesh.rank, "device": str(device)}, {}
    for part in ("b", "c", "d", "e"):
        launches[part] = {}
    with counted_launches(launches["b"]):
        for name, kw in (("shard_map", {}),
                         ("quantized", {"quant_hosts": mesh.world_size,
                                        "quant_block_size": block})):
            out[name], eng = mesh_quick_run(
                torch, cfg.replace(aggregation_backend=name, **kw), data,
                mesh, device)
    out["merge_err"], out["merge_bound"] = quantized_vs_exact(
        torch, eng, mesh, block)
    mesh.barrier()
    out["card_mib_both_ranks"] = card_memory_mib()
    mesh.barrier()
    from fedmse_tpu_torch.parallel.costmodel import plan_merge
    out["plan"] = plan_merge(mesh, [eng.layout.size], repeats=5)
    with counted_launches(launches["c"]):
        out["tier"] = mesh_tier(torch, cfg, mesh, device, tier_n, cohort,
                                host_sharded=True)
    out["serve"] = mesh_serving(torch, cfg, out["shard_map"]["params"],
                                data, mesh, device, launches["d"])
    with counted_launches(launches["e"]):
        out["phase"], eng = mesh_phase_run(torch, phase_quick_config(cfg),
                                           data, mesh, device)
    out["kernels_vs_plain"] = mesh_kernel_shapes(
        torch, device, cfg, eng, out["serve"]["bucket"])
    out["launches"] = launches
    return out


def phase_parallel_e(dense, fused, outs, smi):
    """(e) the ranks' per-phase runs against the dense per-phase card run
    and (b)'s sharded fused run (shard_map): the report; raises on a
    failed hold."""
    ph = outs[0]["phase"]
    scale = max(1.0, float(np.abs(dense["params1"]).max()))
    p1_err = float(np.abs(ph["params1"] - dense["params1"]).max()) / scale
    rep = {"elections": ph["aggregators"],
           "dense_elections": dense["aggregators"],
           "fused_elections": fused["aggregators"],
           "round1_params_fused_bits": _bits_equal(ph["params1"],
                                                   fused["params1"]),
           "round1_param_err_scaled": p1_err, "auc": ph["auc"],
           "dense_auc": dense["auc"], "backend": ph["backend"],
           "phase_seconds": [r["phase"]["phase_seconds"] for r in outs],
           "round_s": [r["phase"]["round_s"] for r in outs],
           "dense_phase_seconds": dense["phase_seconds"],
           "dense_round_s": dense["round_s"],
           "launches": [r["launches"]["e"] for r in outs]}
    for r in outs:
        for k, secs in enumerate(r["phase"]["phase_seconds"]):
            log(f"[parallel] (e) rank {r['rank']} round {k + 1}: wall "
                f"{r['phase']['round_s'][k]:.4f} s, phases "
                f"{json.dumps(secs)} ({smi})")
    for k, secs in enumerate(dense["phase_seconds"]):
        log(f"[parallel] (e) dense per-phase round {k + 1}: wall "
            f"{dense['round_s'][k]:.4f} s, phases {json.dumps(secs)} "
            f"({smi})")
    steady = lambda walls: float(np.mean(walls[1:]))  # noqa: E731
    log(f"[watch] sharded per-phase quick round (2 gloo ranks, one card, "
        f"profile=True, kNN): steady {steady(ph['round_s']):.4f} s; dense "
        f"per-phase {steady(dense['round_s']):.4f} s; sharded fused "
        f"{fused['steady_round_s']:.4f} s ({smi})")
    log(f"[parallel] (e) per-phase on 2 ranks: elections "
        f"{ph['aggregators']} (dense per-phase {dense['aggregators']}, "
        f"(b) fused {fused['aggregators']}), round-1 params (b)'s bits: "
        f"{rep['round1_params_fused_bits']}, {p1_err:.3e} scaled from the "
        f"dense per-phase run, AUC {ph['auc']:.6f} (dense "
        f"{dense['auc']:.6f}), launches {json.dumps(rep['launches'])}")
    if not (ph["selected"] == dense["selected"] == fused["selected"]
            and ph["aggregators"] == dense["aggregators"]
            == fused["aggregators"]):
        raise AssertionError("[parallel] (e) elections differ from the "
                             "dense per-phase run or (b)'s")
    if not rep["round1_params_fused_bits"] or p1_err > 1e-6 or \
            abs(ph["auc"] - dense["auc"]) > 2e-3:
        raise AssertionError(f"[parallel] (e) {json.dumps(rep)}")
    phases = {"train", "vote", "aggregate", "verify", "evaluate"}
    for r in outs:
        for secs in r["phase"]["phase_seconds"]:
            if set(secs) != phases or not all(
                    np.isfinite(v) and v > 0 for v in secs.values()):
                raise AssertionError(f"[parallel] (e) rank {r['rank']}'s "
                                     f"phase seconds {secs}")
        got = r["launches"]["e"]
        for name in ("fused_ae_forward", "fused_ae_train", "dist_tiles"):
            if got.get(name, 0) < 1:
                raise AssertionError(f"[parallel] (e) rank {r['rank']} "
                                     f"never launched {name}: {got}")
    return rep


def phase_parallel(torch, device, cfg, smi):
    """The client mesh (parallel/) on the card: (a) a one-rank NCCL group:
    --use-mesh's world-1 quick run equal to the plain run, the collectives
    on CUDA tensors, plan_merge's table; (b)-(e) two gloo ranks on the one
    card (parallel_rank), held to the dense card runs and to each other.
    Launch counters set to 0 before and read after each meshed run (the
    world-1 mesh run, each rank's sharded runs, tier and meshed engine;
    not the plain runs they are held to), summed over the parent and the
    ranks (the parallel path)."""
    import torch.distributed as dist
    from fedmse_tpu_torch.parallel import collectives as coll
    from fedmse_tpu_torch.parallel import launch, multihost
    from fedmse_tpu_torch.parallel.costmodel import plan_merge
    from fedmse_tpu_torch.parallel.mesh import client_mesh
    t0 = time.perf_counter()
    qc, data = parallel_quick(torch, cfg)
    report = {}
    PARALLEL_LAUNCHES.clear()
    store_path = os.path.join(ROOT, "build", f"parallel_store_{os.getpid()}")
    if os.path.exists(store_path):
        os.remove(store_path)
    cuda = device.type == "cuda"
    multihost.initialize(store=dist.FileStore(store_path, 1), world_size=1,
                         rank=0, backend="nccl" if cuda else "gloo",
                         device=device.type)
    try:
        mesh1 = client_mesh(device=device)
        dense, _ = mesh_quick_run(torch, qc, data, None, device)
        with counted_launches(PARALLEL_LAUNCHES):
            one, eng1 = mesh_quick_run(torch, qc, data, mesh1, device)
        same = (one["aggregators"] == dense["aggregators"]
                and all(_bits_equal(a, b) for a, b in zip(one["metrics"],
                                                          dense["metrics"]))
                and _bits_equal(one["params"], dense["params"])
                and _bits_equal(one["final"], dense["final"]))
        report["a_world1_equals_plain"] = same
        if not same:
            raise AssertionError("[parallel] (a) the world-1 mesh run is "
                                 "not the plain run's bits")
        # a mesh of one is no mesh: the same graphs, one stretch each
        shape = [{g: (st["nodes"], st["segments"], st["kernels_per_replay"])
                  for g, st in r["graphs"].items()} for r in (one, dense)]
        report["a_graphs"] = {g: st["nodes"]
                              for g, st in dense["graphs"].items()}
        if shape[0] != shape[1] or any(
                st["segments"] > 1 for st in dense["graphs"].values()):
            raise AssertionError(f"[parallel] (a) graphs differ: {shape}")
        p, sel, dev_x = eng1.states.params, eng1.data.client_mask, \
            eng1.data.dev_x
        plain_m, plain_w = eng1.aggregate(p, sel, dev_x)
        sm_m, sm_w = coll.make_shardmap_aggregate(
            eng1.model, "mse_avg", mesh1)(p, sel, dev_x)
        q1_m, _ = coll.make_hierarchical_aggregate(
            eng1.model, "mse_avg", mesh1, num_groups=1)(p, sel, dev_x)
        torch.cuda.synchronize()
        report["a_collectives"] = {
            "backend": mesh1.backend,
            "shard_map_equals_einsum": _bits_equal(sm_m.cpu(), plain_m.cpu())
            and _bits_equal(sm_w.cpu(), plain_w.cpu()),
            "quantized_one_group_equals_shard_map": _bits_equal(
                q1_m.cpu(), sm_m.cpu())}
        log(f"[parallel] (a) world 1 on {mesh1.backend}: the --use-mesh "
            f"quick run is the plain run's bits ({dense['aggregators']}, "
            f"AUC {dense['auc']:.6f}) and graphs (one stretch each, nodes "
            f"{json.dumps(report['a_graphs'])}); collectives on CUDA tensors "
            f"{json.dumps(report['a_collectives'])}")
        if not all(v for k, v in report["a_collectives"].items()
                   if k != "backend"):
            raise AssertionError(f"[parallel] (a) {report['a_collectives']}")
        plan = plan_merge(mesh1, [eng1.layout.size], repeats=5)
        report["a_plan"] = plan
        for c in plan["candidates"]:
            log(f"[watch] plan_merge world 1 ({mesh1.backend}) "
                f"{c['backend']} groups={c['num_groups']} "
                f"block={c['block_size']}: wall {c['wall_s'] * 1e3:.5f} ms "
                f"({smi})")
    finally:
        multihost.shutdown()
        if os.path.exists(store_path):
            os.remove(store_path)
    # (e)'s reference: the dense per-phase run on the card (not counted)
    dense_phase, _ = mesh_phase_run(torch, phase_quick_config(qc), data,
                                    None, device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    workdir = os.path.join(ROOT, "build", "parallel_ranks")
    shutil.rmtree(workdir, ignore_errors=True)
    outs = launch.spawn(PARALLEL_WORLD, PARALLEL_JOB,
                        {"tier_n": PARALLEL_TIER_N,
                         "cohort": PARALLEL_TIER_COHORT,
                         "block": PARALLEL_BLOCK},
                        backend="gloo", device=device.type, workdir=workdir,
                        timeout_s=600)
    shutil.rmtree(workdir, ignore_errors=True)  # kept after a failure
    report["ranks_s"] = time.perf_counter() - t1
    r0 = outs[0]
    for r in outs[1:]:  # every rank's results: the same bits
        for key in ("shard_map", "quantized", "tier", "phase"):
            same = r[key]["aggregators"] == r0[key]["aggregators"] and all(
                _bits_equal(r[key][f], r0[key][f])
                for f in ("final", "params") if f in r[key])
            if not same:
                raise AssertionError(f"[parallel] rank {r['rank']}'s {key} "
                                     "results differ from rank 0's")
    sm = r0["shard_map"]
    scale = max(1.0, float(np.abs(dense["params1"]).max()))
    p1_err = float(np.abs(sm["params1"] - dense["params1"]).max()) / scale
    report["b"] = {
        "elections": sm["aggregators"], "dense_elections":
        dense["aggregators"], "round1_param_err_scaled": p1_err,
        "auc": sm["auc"], "dense_auc": dense["auc"],
        "quantized_auc": r0["quantized"]["auc"],
        "quantized_elections": r0["quantized"]["aggregators"],
        "merge_err": r0["merge_err"], "merge_bound": r0["merge_bound"],
        "card_mib_both_ranks": [r["card_mib_both_ranks"] for r in outs],
        "sharded_round1_s": sm["round1_s"],
        "sharded_steady_round_s": sm["steady_round_s"],
        "dense_round1_s": dense["round1_s"],
        "dense_steady_round_s": dense["steady_round_s"],
        "leave_segments": sm["graphs"]["leave"]["segments"],
        "launches": [r["launches"] for r in outs]}
    log(f"[parallel] (b) 2 gloo ranks on one card, shard_map: elections "
        f"{sm['aggregators']} (dense {dense['aggregators']}), round-1 "
        f"params {p1_err:.3e} scaled, AUC {sm['auc']:.6f} (dense "
        f"{dense['auc']:.6f}); quantized AUC {r0['quantized']['auc']:.6f}, "
        f"merge error {r0['merge_err']:.3e} <= bound "
        f"{r0['merge_bound']:.3e}; card memory with both ranks up "
        f"{report['b']['card_mib_both_ranks']} MiB ({smi})")
    report["b_plan"] = r0["plan"]
    for c in r0["plan"]["candidates"]:
        log(f"[watch] plan_merge 2 gloo ranks, one card: {c['backend']} "
            f"groups={c['num_groups']} block={c['block_size']}: wall "
            f"{c['wall_s'] * 1e3:.5f} ms, score {c['score_s'] * 1e3:.5f} ms "
            f"({smi})")
    log(f"[parallel] (b) plan_merge chose {json.dumps(r0['plan']['chosen'])}"
        f" on every rank: "
        f"{all(r['plan']['chosen'] == r0['plan']['chosen'] for r in outs)}")
    if any(r["plan"]["chosen"] != r0["plan"]["chosen"] for r in outs):
        raise AssertionError("[parallel] the ranks chose different plans")
    log(f"[watch] sharded quick round (2 gloo ranks, one card): round 1 "
        f"{sm['round1_s']:.4f} s, steady {sm['steady_round_s']:.4f} s; "
        f"dense {dense['round1_s']:.4f} s / {dense['steady_round_s']:.4f} s "
        f"({smi})")
    if sm["aggregators"] != dense["aggregators"] or \
            sm["selected"] != dense["selected"]:
        raise AssertionError("[parallel] (b) elections differ from the "
                             "dense card run")
    if p1_err > 1e-6 or abs(sm["auc"] - dense["auc"]) > 2e-3:
        raise AssertionError(f"[parallel] (b) {json.dumps(report['b'])}")
    if not r0["merge_err"] <= r0["merge_bound"] + 1e-7:
        raise AssertionError("[parallel] (b) the quantized merge is outside "
                             "its codec bound")
    for r in outs:
        got = r["launches"]["b"]
        if got.get("fused_ae_forward", 0) < 1 or \
                got.get("fused_ae_train", 0) < 1:
            raise AssertionError(f"[parallel] rank {r['rank']} never "
                                 f"launched forward and train: {got}")
    tier = [r["tier"] for r in outs]
    one_tier = mesh_tier(torch, qc, None, device, PARALLEL_TIER_N,
                         PARALLEL_TIER_COHORT, host_sharded=False,
                         selections=tier[0]["selected"])
    report["c"] = {
        "auc": tier[0]["auc"], "one_process_auc": one_tier["auc"],
        "aggregators": tier[0]["aggregators"],
        "one_process_aggregators": one_tier["aggregators"],
        "rows": [t["rows"] for t in tier], "cohort": tier[0]["cohort"],
        "host_state_bytes": [t["host_state_bytes"] for t in tier],
        "one_process_host_state_bytes": one_tier["host_state_bytes"],
        "host_data_bytes": [t["host_data_bytes"] for t in tier],
        "one_process_host_data_bytes": one_tier["host_data_bytes"],
        "seconds": [t["seconds"] for t in tier],
        "one_process_seconds": one_tier["seconds"]}
    log(f"[parallel] (c) host-sharded tier, {PARALLEL_TIER_N} gateways on 2 "
        f"ranks, C = {tier[0]['cohort']}: AUC {tier[0]['auc']:.6f} (one "
        f"process {one_tier['auc']:.6f}), rows {report['c']['rows']}, host "
        f"state bytes {report['c']['host_state_bytes']} (one process "
        f"{one_tier['host_state_bytes']})")
    blocks = [(0, PARALLEL_TIER_N // 2),
              (PARALLEL_TIER_N // 2, PARALLEL_TIER_N)]
    if [tuple(t["rows"]) for t in tier] != blocks or \
            abs(tier[0]["auc"] - one_tier["auc"]) > 2e-3 or \
            2 * tier[0]["host_state_bytes"] != one_tier["host_state_bytes"]:
        raise AssertionError(f"[parallel] (c) {json.dumps(report['c'])}")
    report["e"] = phase_parallel_e(dense_phase, sm, outs, smi)
    report["d"] = [r["serve"] for r in outs]
    log(f"[parallel] (d) meshed kNN engine on 2 ranks: "
        f"{json.dumps(report['d'])}")
    if not all(s["bits"] and s["gateway_sharded"] for s in report["d"]):
        raise AssertionError("[parallel] (d) the meshed engine's scores are "
                             "not the unsharded engine's bits")
    for r in outs:
        if r["launches"]["d"].get("dist_tiles", 0) < 1:
            raise AssertionError(f"[parallel] rank {r['rank']}'s meshed kNN "
                                 "engine never launched the distances")
        for part in r["launches"].values():
            for k, v in part.items():
                PARALLEL_LAUNCHES[k] = PARALLEL_LAUNCHES.get(k, 0) + v
    report["kernels_vs_plain"] = [r["kernels_vs_plain"] for r in outs]
    log(f"[parallel] kernels at each rank's shapes agree with their plain "
        f"versions and with a second call: "
        f"{json.dumps(report['kernels_vs_plain'])}")
    report["launches"] = dict(PARALLEL_LAUNCHES)
    log(f"[parallel] parallel path launches {json.dumps(report['launches'])}")
    for name in ("fused_ae_forward", "fused_ae_train", "dist_tiles"):
        if report["launches"].get(name, 0) < 1:
            raise AssertionError(f"the parallel path never launched {name}")
    report["seconds"] = time.perf_counter() - t0
    log(f"[parallel] done in {report['seconds']:.1f} s ({smi})")
    return report


# ---- the real-data pipeline (phase "realdata") ---- #

REALDATA_DEVICES = 9        # N-BaIoT's devices
REALDATA_BENIGN = 3_100     # rows a device's benign file: 27,900 normal rows
REALDATA_ATTACK = 1_780     # rows a mirai / gafgyt file: 32,040 attack rows
REALDATA_CLIENTS = 10
REALDATA_LAUNCHES = {}      # the real-data path's kernel launches


def write_raw_tree(root):
    """A raw tree in N-BaIoT's layout, <device>/normal/benign_traffic.csv and
    <device>/abnormal/{mirai_udp,gafgyt_tcp}.csv, each file with a header
    line and 7 significant digits a value, from the port's seeded
    shifted-Gaussian generator (synthetic_clients(noniid=True): one mode a
    device, its attacks shifted off it). Returns (files, bytes)."""
    from fedmse_tpu_torch.data import synthetic_clients
    clients = synthetic_clients(n_clients=REALDATA_DEVICES, dim=DIMS[0],
                                n_normal=REALDATA_BENIGN,
                                n_abnormal=2 * REALDATA_ATTACK,
                                seed=SEED + 60, noniid=True)
    header = ",".join(f"f{j}" for j in range(DIMS[0]))
    files = nbytes = 0
    for i, c in enumerate(clients):
        s = c.scaler

        def raw(x, s=s):  # the generator's rows before its scaler
            return x.astype(np.float64) * s.scale_ + s.mean_

        normal = np.concatenate([raw(c.train_x), raw(c.valid_x), c.dev_raw,
                                 raw(c.test_x[c.test_y == 0])])
        attack = raw(c.test_x[c.test_y == 1])
        for sub, name, rows in (
                ("normal", "benign_traffic.csv", normal),
                ("abnormal", "mirai_udp.csv", attack[:REALDATA_ATTACK]),
                ("abnormal", "gafgyt_tcp.csv", attack[REALDATA_ATTACK:])):
            d = os.path.join(root, f"Device_{i}", sub)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, name)
            np.savetxt(path, rows, fmt="%.7g", delimiter=",", header=header,
                       comments="")
            files += 1
            nbytes += os.path.getsize(path)
    return files, nbytes


def run_prep(args, what):
    """`python -m fedmse_tpu_torch.data.prep <args>` as a user runs it: its
    wall seconds and the JS distances of its last line."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "fedmse_tpu_torch.data.prep",
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"[realdata] prep {what} failed "
                             f"(exit {out.returncode}):\n"
                             f"{out.stderr[-4000:]}")
    js = json.loads(out.stdout.strip().splitlines()[-1])["js_distance"]
    log(f"[realdata] prep {what}: {seconds:.2f} s, JS distance "
        f"{json.dumps(js)}")
    return {"seconds": seconds, "js_distance": js}


def prep_args(raw, noniid, matrix, device_type):
    """The two prep commands' arguments: the raw tree to non-IID shards
    (alpha 0.5 over REALDATA_CLIENTS clients, every row), and those shards
    to the published split (--target-matrix --cluster-labels 9)."""
    dev = ["--device", device_type]
    return (["--raw", raw, "--out", noniid, "--n-clients",
             str(REALDATA_CLIENTS), "--mode", "noniid", "--alpha", "0.5",
             "--benign-frac", "1.0", "--abnormal-frac", "1.0", *dev],
            ["--source", noniid, "--out", matrix, "--n-clients",
             str(REALDATA_CLIENTS), "--target-matrix", "--cluster-labels",
             "9", *dev])


def study_tree(root, device_type="cuda"):
    """The [realdata] phase's published-split Client-* tree, built under
    `root` (the raw tree, then both prep commands): the input of the paper
    check and parity probe runs. Returns the tree's path. From the repo
    root: `python3 -c "import chip_smoke; chip_smoke.study_tree('build/
    study-tree')"`."""
    raw, noniid, matrix = (os.path.join(root, d)
                           for d in ("raw", "noniid", "matrix"))
    write_raw_tree(raw)
    for args, what in zip(prep_args(raw, noniid, matrix, device_type),
                          ("--raw", "--source --target-matrix")):
        run_prep(args, what)
    shutil.rmtree(raw)
    return matrix


def parse_shards(trees):
    """Every shard of `trees` through the host reader (read_dir_f64, as
    load_data reads a split) and through np.loadtxt: the same float64
    bits, and each route's MB/s."""
    from fedmse_tpu_torch.data.fast_csv import read_dir_f64
    dirs = sorted(os.path.join(d, c, s) for d in trees
                  for c in os.listdir(d) for s in os.listdir(os.path.join(d, c)))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d in dirs
                 for f in os.listdir(d))
    t0 = time.perf_counter()
    native = [read_dir_f64(d, allow_header=False) for d in dirs]
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [np.concatenate([np.loadtxt(os.path.join(d, f), delimiter=",",
                                        dtype=np.float64, ndmin=2)
                             for f in sorted(os.listdir(d))]) for d in dirs]
    t_plain = time.perf_counter() - t0
    for d, a, b in zip(dirs, native, plain):
        if a.shape != b.shape or not np.array_equal(a.view(np.int64),
                                                    b.view(np.int64)):
            raise AssertionError(f"[realdata] {d}: the host reader's float64 "
                                 "bits differ from np.loadtxt's")
    out = {"shards": len(dirs), "bytes": nbytes,
           "rows": int(sum(len(a) for a in native)),
           "native_s": t_native, "loadtxt_s": t_plain,
           "native_mb_s": nbytes / 1e6 / t_native,
           "loadtxt_mb_s": nbytes / 1e6 / t_plain}
    log(f"[realdata] parsed {out['shards']} shards ({nbytes / 1e6:.1f} MB, "
        f"{out['rows']} rows): the host reader {out['native_mb_s']:.1f} MB/s"
        f", np.loadtxt {out['loadtxt_mb_s']:.1f} MB/s, the same float64 bits")
    return out


def realdata_kernel_shapes(torch, device, data, cfg):
    """The kernels at the real-data path's shapes against their plain
    versions, f32 on dyadic grids, each also bit-equal to a second call:
    the forward over the 10 models client-major at the evaluation's rows
    (test plus train rows a client), the train step at the round's cohort
    (G = the selected clients, R = the batch), the distances at the
    evaluation's test rows against 10 banks of 512."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    n, t = data.test_x.shape[:2]
    s = data.train_xb.shape[1] * data.train_xb.shape[2]
    g = max(1, int(cfg.num_participants * n))
    worst = routed_kernel_shapes(torch, device, "realdata", n,
                                 [(n * (t + s), "client_major")],
                                 dist_rows=(n * t,))
    gen = torch.Generator().manual_seed(SEED + 61)
    layout = ParamLayout(*DIMS)
    kw = dict(layout=layout, shrink_lambda=cfg.shrink_lambda)
    flat, xt = grid_inputs(torch, layout, g, cfg.batch_size, gen, device)
    m = torch.ones((g, cfg.batch_size), device=device)
    got = fused_train_grads(flat, xt, m, **kw)
    if not all(torch.equal(a, b) for a, b in zip(
            got, fused_train_grads(flat, xt, m, **kw))):
        raise AssertionError("[realdata] train launch not bit-equal to a "
                             "second call")
    what = f"train step, G = {g}, R = {cfg.batch_size}"
    worst[what] = max(scaled_err(a, b) for a, b in zip(
        got, fused_train_grads_plain(flat, xt, m, **kw)))
    if worst[what] > TOL["f32"]:
        raise AssertionError(f"[realdata] {what}: {worst[what]}")
    log(f"[realdata] kernels at the path's shapes agree with their plain "
        f"versions and with a second call: {json.dumps(worst)}")
    return worst


def realdata_train(torch, device, cfg, shards, ckpt):
    """`python -m fedmse_tpu_torch.main --dataset-config` on the shards
    (in-process through main(), so its launches count): the quick run,
    hybrid / mse_avg, then one kNN-scored evaluation of the checkpoint it
    wrote over the same federation."""
    from fedmse_tpu_torch.checkpointing import (ResultsWriter,
                                                load_client_models)
    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.main import main as driver_main
    from fedmse_tpu_torch.main import prepare_federation
    from fedmse_tpu_torch.models import make_model
    ds_path = os.path.join(ckpt, "dataset.json")
    os.makedirs(ckpt, exist_ok=True)
    with open(ds_path, "w") as f:
        json.dump(DatasetConfig.for_client_dirs(
            shards, REALDATA_CLIENTS).to_json(), f)
    exp = "chip-smoke-realdata"
    t0 = time.perf_counter()
    out = driver_main(["--dataset-config", ds_path, "--model-types",
                       "hybrid", "--update-types", "mse_avg",
                       "--network-size", str(REALDATA_CLIENTS),
                       "--checkpoint-dir", ckpt, "--experiment-name", exp,
                       "--device", device.type])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    final = np.asarray(out["results"]["hybrid/mse_avg/run0"]["final_metrics"])
    if final.shape != (REALDATA_CLIENTS,) or not np.isfinite(final).all():
        raise AssertionError(f"[realdata] final AUC: {final}")
    run_cfg = cfg.replace(network_size=REALDATA_CLIENTS,
                          checkpoint_dir=ckpt, experiment_name=exp)
    clients, data, n = prepare_federation(
        run_cfg, DatasetConfig.from_json(ds_path), device=device)
    writer = ResultsWriter(ckpt, run_cfg.network_size, exp,
                           run_cfg.scen_name, run_cfg.metric,
                           run_cfg.num_participants)
    model = make_model("hybrid", *DIMS, shrink_lambda=cfg.shrink_lambda,
                       device=device)
    params = load_client_models(writer, 0, "hybrid", "mse_avg",
                                [c.name for c in clients], device=device)
    t0 = time.perf_counter()
    knn_auc = make_evaluate_all(model, "hybrid", score_kind="knn", **KNN)(
        params, data.test_x, data.test_m, data.test_y, data.train_xb,
        data.train_mb).cpu().numpy()
    knn_s = time.perf_counter() - t0
    if not np.isfinite(knn_auc).all():
        raise AssertionError(f"[realdata] kNN AUC: {knn_auc}")
    log(f"[realdata] main --dataset-config: {train_s:.2f} s, final mean AUC "
        f"{final.mean():.6f} (per client {np.round(final, 6).tolist()}); "
        f"kNN-scored evaluation of its checkpoint {knn_s * 1e3:.2f} ms, mean "
        f"AUC {knn_auc.mean():.6f}")
    return {"train_s": train_s, "final_mean_auc": float(final.mean()),
            "final_auc": final.tolist(), "knn_s": knn_s,
            "knn_mean_auc": float(knn_auc.mean()),
            "test_rows": int(data.test_m.sum())}, data, writer


def realdata_plots(writer, out_dir):
    """load_round_results on the run's results (non-empty), and plot_results:
    PNGs where matplotlib is installed, else an ImportError naming it."""
    from fedmse_tpu_torch.utils.platform import capture_provenance
    from fedmse_tpu_torch.visualization import (load_round_results,
                                                plot_results)
    combos = load_round_results(writer.results_dir)
    if not combos or not all(combos.values()):
        raise AssertionError(f"[realdata] no round results under "
                             f"{writer.results_dir}")
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    try:
        pngs = plot_results(writer.results_dir, out_dir)
    except ImportError as e:
        if has_mpl or "matplotlib" not in str(e):
            raise
        pngs = f"ImportError: {e}"
    else:
        if not has_mpl or len(pngs) != 2 or not all(
                os.path.getsize(p) > 0 for p in pngs):
            raise AssertionError(f"[realdata] plot_results wrote {pngs}")
    prov = capture_provenance()
    log(f"[realdata] round results of {sorted(combos)} "
        f"({sum(len(r) for r in combos.values())} rounds); plot_results: "
        f"{pngs}; provenance {json.dumps(prov)}")
    return {"combos": sorted(combos), "plots": pngs, "provenance": prov}


def phase_realdata(torch, device, cfg, smi, keep=None):
    """The real-data pipeline: a raw N-BaIoT-shaped tree (9 devices, 115
    features, header lines) written from the port's generator; `python -m
    fedmse_tpu_torch.data.prep` from it (--raw, non-IID alpha 0.5 over 10
    clients, every row) and from those shards (--source --target-matrix
    --cluster-labels 9, the published split); every shard parsed by the
    host reader and by np.loadtxt, the same bits; the driver trained on
    the published-split shards (--dataset-config, the quick run) and a
    kNN-scored evaluation of its checkpoint, launch counters set to 0
    before and read after (the real-data path); the round results loaded
    and plotted; then the kernels at the path's shapes. `keep` (a path)
    keeps the published-split shards there for a later phase."""
    import tempfile
    t0 = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        raw = os.path.join(tmp, "raw")
        files, nbytes = write_raw_tree(raw)
        report["raw"] = {"files": files, "bytes": nbytes,
                         "seconds": time.perf_counter() - t0}
        log(f"[realdata] raw tree: {REALDATA_DEVICES} devices, {files} files "
            f"with header lines, {nbytes / 1e6:.1f} MB "
            f"({REALDATA_DEVICES * REALDATA_BENIGN} benign and "
            f"{2 * REALDATA_DEVICES * REALDATA_ATTACK} attack rows: the "
            f"published split's pool at every row sampled, not N-BaIoT's ~7M "
            f"raw rows)")
        noniid, matrix = os.path.join(tmp, "noniid"), os.path.join(tmp,
                                                                   "matrix")
        args_raw, args_matrix = prep_args(raw, noniid, matrix, device.type)
        report["prep_raw"] = run_prep(args_raw, "--raw (noniid, alpha 0.5)")
        report["prep_matrix"] = run_prep(
            args_matrix, "--source --target-matrix --cluster-labels 9")
        report["parse"] = parse_shards([noniid, matrix])
        REALDATA_LAUNCHES.clear()
        with counted_launches(REALDATA_LAUNCHES):
            report["train"], data, writer = realdata_train(
                torch, device, cfg, matrix, os.path.join(tmp, "ckpt"))
        report["launches"] = dict(REALDATA_LAUNCHES)
        log(f"[realdata] real-data path launches "
            f"{json.dumps(report['launches'])}")
        for name in ("fused_ae_forward", "fused_ae_train", "dist_tiles"):
            if report["launches"].get(name, 0) < 1:
                raise AssertionError(f"the real-data path never launched "
                                     f"{name}")
        if report["train"]["final_mean_auc"] <= 0.9:
            raise AssertionError(f"[realdata] final mean AUC "
                                 f"{report['train']['final_mean_auc']} "
                                 "<= 0.9")
        report["plots"] = realdata_plots(writer, os.path.join(tmp, "plots"))
        report["kernels_vs_plain"] = realdata_kernel_shapes(torch, device,
                                                            data, cfg)
        if keep is not None:
            shutil.move(matrix, keep)
    report["seconds"] = time.perf_counter() - t0
    log(f"[realdata] done in {report['seconds']:.1f} s ({smi})")
    return report


# ---- the threat-model sweep drivers (phase "sweeps") ---- #

SWEEP_G = (100, 200)      # the churn grid's and the 10k pin's cohorts
SWEEP_ROUNDS = 4          # the attack and chaos cells' rounds, (a), (b)
SWEEP_BURST = (1, 3)      # the burst rows' window, over 2 x SWEEP_ROUNDS
SWEEP_PIN = (64, 8)       # the capture-once pin cut from (10,000, 200)
SWEEP_LAUNCHES = {}       # the sweep path's kernel launches, by wrapper


def sweep_kernel_shapes(torch, device):
    """The train step and the forward at the sweeps' cohort widths against
    their plain versions, f32 on dyadic grids, each also bit-equal to a
    second call: the train step at G = 100 and 200 (12 rows a client),
    the forward over G routed models client-major (28 rows a model: the
    thin shards' test and train rows). Returns the worst scaled errors."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 31)
    layout = ParamLayout(*DIMS)
    kw = dict(layout=layout, shrink_lambda=10.0)
    worst = {}
    for g in SWEEP_G:
        flat, xt = grid_inputs(torch, layout, g, 12, gen, device)
        m = torch.ones((g, 12), device=device)
        got = fused_train_grads(flat, xt, m, **kw)
        again = fused_train_grads(flat, xt, m, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"[sweeps] train launch at G = {g} not "
                                 "bit-equal to a second call")
        worst[f"train step, G = {g}"] = max(scaled_err(a, b) for a, b in zip(
            got, fused_train_grads_plain(flat, xt, m, **kw)))
        params = grid_params(torch, g, *DIMS, gen, device, torch.float32)
        rows = g * 28
        x = (torch.randint(-6, 7, (rows, DIMS[0]), generator=gen) / 4.0
             ).to(device)
        idx = forward_index(torch, "client_major", g, rows, gen, device)
        got = fused_forward_stats(params, x, idx)
        again = fused_forward_stats(params, x, idx)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"[sweeps] forward over {g} models not "
                                 "bit-equal to a second call")
        worst[f"forward, {g} routed models"] = max(
            scaled_err(a, b) for a, b in zip(
                got, fused_forward_stats_plain(params, x, idx)))
    bad = {k: v for k, v in worst.items() if v > TOL["f32"]}
    if bad:
        raise AssertionError(f"[sweeps] kernels vs plain: {bad}")
    log(f"[sweeps] kernels at the sweeps' cohort widths agree with their "
        f"plain versions and with a second call: {json.dumps(worst)}")
    return worst


def sweep_attack(torch, device, cfg, data, n):
    """(a) attack_sweep_torch's baseline and scale-10 cells in both modes
    (SWEEP_ROUNDS rounds, attacked from round 1): the baseline accepts
    every broadcast, and under scale 10 every verifying client with a
    verification history rejects (a first contact has none to hold the
    broadcast to)."""
    import attack_sweep_torch as attack
    out = {}
    for mode, hardened in (("reference", False), ("hardened", True)):
        c = cfg.replace(hardened_verification=hardened)
        with counted_launches(SWEEP_LAUNCHES):
            base = attack.run_cell(c, data, n, None, 0.0, rounds=SWEEP_ROUNDS)
            scaled = attack.run_cell(c, data, n, "scale", 10.0,
                                     rounds=SWEEP_ROUNDS)
        out[mode] = {"baseline": base, "scale10": scaled}
        log(f"[sweeps] (a) {mode}: baseline accept_rate "
            f"{base['accept_rate']} final AUC {base['final_auc']}; scale-10 "
            f"accept_rate {scaled['accept_rate']}, accepts after first "
            f"contact {scaled['accepts_after_first_contact']}, rejected "
            f"curve {scaled['mean_rejected_curve']}")
        if base["accept_rate"] != 1.0:
            raise AssertionError(f"[sweeps] (a) {mode}: the clean baseline "
                                 f"accepted {base['accept_rate']}")
        if scaled["accepts_after_first_contact"] != 0 \
                or scaled["accept_rate"] is None:
            raise AssertionError(f"[sweeps] (a) {mode}: a verifying client "
                                 f"accepted the scale-10 broadcast: {scaled}")
    return out


def sweep_chaos(torch, device, cfg, data, n):
    """(b) chaos_sweep_torch's (0, 0) cell against the clean engine (the
    same init and schedule, no hook): the same per-client metrics, bit for
    bit, and the same AUC curve; then the attack and churn bursts over
    [1, 3) in 2 x SWEEP_ROUNDS rounds: rounds_to_recover finite."""
    import chaos_sweep_torch as chaos
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.attack import AttackSpec
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    with counted_launches(SWEEP_LAUNCHES):
        cell = chaos.run_cell(cfg, data, n, None, rounds=SWEEP_ROUNDS,
                              label="baseline")
    clean = RoundEngine(make_model("hybrid", cfg.dim_features,
                                   shrink_lambda=cfg.shrink_lambda,
                                   device=device), cfg, data, n,
                        ExperimentRngs(run=0, data_seed=cfg.data_seed),
                        "hybrid", "mse_avg", fused=True)
    results = clean.run_rounds(0, SWEEP_ROUNDS)
    curve = [round(float(np.nanmean(r.client_metrics)), 5) for r in results]
    if cell["auc_curve"] != curve or not np.array_equal(
            np.asarray(cell["final_client_metrics"]),
            results[-1].client_metrics, equal_nan=True):
        raise AssertionError(f"[sweeps] (b) the (0, 0) cell "
                             f"{cell['auc_curve']} is not the clean "
                             f"engine's {curve}")
    b0, b1 = SWEEP_BURST
    with counted_launches(SWEEP_LAUNCHES):
        bursts = [chaos.run_cell(
            cfg, data, n, None, attack_spec=AttackSpec(
                kind="zero", start_round=b0, stop_round=b1),
            rounds=2 * SWEEP_ROUNDS, burst=SWEEP_BURST, label="attack-burst"),
            chaos.run_cell(
                cfg, data, n, ChaosSpec(dropout_p=0.8, crash_p=0.5,
                                        start_round=b0, stop_round=b1),
                rounds=2 * SWEEP_ROUNDS, burst=SWEEP_BURST,
                label="churn-burst")]
    recover = {r["label"]: r["burst"]["rounds_to_recover"] for r in bursts}
    log(f"[sweeps] (b) the (0, 0) cell is the clean engine's bits (AUC "
        f"curve {curve}); rounds_to_recover {json.dumps(recover)}")
    if any(v is None for v in recover.values()):
        raise AssertionError(f"[sweeps] (b) a burst never recovered: "
                             f"{recover}")
    return {"baseline": cell, "bursts": bursts}


def sweep_churn(torch, device, cfg):
    """(c) churn_sweep_torch's capture-once pin cut to SWEEP_PIN (64
    clients, cohort 8, from 10,000 and 200): each CUDA graph body captured
    once across the churning chunks, and null churn static bit for bit."""
    import churn_sweep_torch as churn
    with counted_launches(SWEEP_LAUNCHES):
        pin = churn.capture_once_pin(cfg, device, *SWEEP_PIN)
    log(f"[sweeps] (c) capture-once pin at {SWEEP_PIN[0]} clients, cohort "
        f"{pin['cohort']}: captured once {pin['captured_once']}, bodies "
        f"{json.dumps(pin['bodies_after_churn_chunks'])}, null churn "
        f"bit-equal {pin['null_churn_bitwise_identical']}")
    if device.type == "cuda" and not pin["captured_once"]:
        raise AssertionError(f"[sweeps] (c) a body was captured again: {pin}")
    if not pin["null_churn_bitwise_identical"]:
        raise AssertionError("[sweeps] (c) null churn is not the static "
                             "round's bits")
    return pin


def sweep_redteam(torch, device):
    """(d) redteam_sweep_torch.quick_cell: the defenses-off pin, the
    mimicry capture at the cluster bar's blend, the margin floor."""
    import redteam_sweep_torch as redteam
    with counted_launches(SWEEP_LAUNCHES):
        quick = redteam.quick_cell(device)
    log(f"[sweeps] (d) red-team quick cell {json.dumps(quick)}")
    if not quick["acceptance_met"]:
        raise AssertionError(f"[sweeps] (d) quick cell {quick}")
    return quick


def phase_sweeps(torch, device, cfg):
    """The threat-model sweep drivers at reduced grids (attack, chaos,
    churn, red team; sweep_data_torch.py's data), each gate one the JAX
    sweeps state: the kernels at the sweeps' cohort widths first, then
    (a)-(d), whose driver calls are the sweep path (every launch counter
    set to 0 before each and read after)."""
    import sweep_data_torch as sweep
    t0 = time.perf_counter()
    report = {"kernels": sweep_kernel_shapes(torch, device)}
    SWEEP_LAUNCHES.clear()
    data, n, _ = sweep.build_data(cfg, 10, device=device)
    report["attack"] = sweep_attack(torch, device, cfg, data, n)
    report["chaos"] = sweep_chaos(torch, device, cfg, data, n)
    del data
    report["churn"] = sweep_churn(torch, device, cfg)
    report["redteam"] = sweep_redteam(torch, device)
    report["launches"] = dict(SWEEP_LAUNCHES)
    log(f"[sweeps] sweep path launches {json.dumps(report['launches'])}")
    for name in ("fused_ae_forward", "fused_ae_train"):
        if report["launches"].get(name, 0) < 1:
            raise AssertionError(f"the sweep path never launched {name}")
    report["seconds"] = time.perf_counter() - t0
    log(f"[sweeps] done in {report['seconds']:.1f} s")
    return report


# ---- the study drivers (phase "studies") ---- #

# (f): (what, widths, train step G x rows, forward models x rows a model,
# distance banks x slots x query rows or None) of the study drivers'
# launches: the cluster grids (16/12/5 on 24 gateways, cohort 12, batches
# of 16, the kNN cells at L = 5 against 64-slot banks), --podscale's tier
# cohort (8/6/3, 100,000 gateways, 16 test rows each) and the drift grid
# (16/27/7 on 6 gateways, cohort 3 of 12-row batches, 258 client-major
# rows for a 256-row serving bucket, the kNN cell's 128-slot banks)
STUDY_SHAPES = (
    ("cluster grids", (16, 12, 5), (12, 16), (24, 120), (24, 64, 2880)),
    ("podscale cohort", (8, 6, 3), (100_000, 16), (100_000, 16), None),
    ("drift grid", (16, 27, 7), (3, 12), (6, 43), (6, 128, 256)),
)
STUDY_PLAIN_MODELS = 1024  # (f): forward models held to the plain loop
STUDY_LAUNCHES = {}        # the study path's kernel launches, by wrapper


def _one_kernel(torch, fn, device, name, what):
    nodes, ran = kernels_of_one_call(torch, fn, device)
    if nodes != 1 or ran != {name: 1}:
        raise AssertionError(f"[studies] {what}: one call ran {nodes} graph "
                             f"nodes, kernels {ran}, not one {name}")


def study_kernel_shapes(torch, device):
    """(f) The three kernels at the study drivers' widths (STUDY_SHAPES)
    against their plain versions, f32 on dyadic grids, each call bit-equal
    to a second call and one CUDA kernel per call (a captured graph's
    nodes). The forward over more than STUDY_PLAIN_MODELS models is held
    to the plain version on the rows of a random sample of that many
    models (the plain version loops over models; the kernel's rows are
    independent of each other). Returns the worst scaled errors."""
    from fedmse_tpu_torch.knn.score import dist_tiles
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 53)
    worst = {}
    for what, dims, (g, rows), (models, per), dist in STUDY_SHAPES:
        layout = ParamLayout(*dims)
        kw = dict(layout=layout, shrink_lambda=10.0)
        flat, xt = grid_inputs(torch, layout, g, rows, gen, device)
        m = torch.ones((g, rows), device=device)
        got = fused_train_grads(flat, xt, m, **kw)
        if not all(torch.equal(a, b) for a, b in zip(
                got, fused_train_grads(flat, xt, m, **kw))):
            raise AssertionError(f"[studies] train step, {what}: not "
                                 "bit-equal to a second call")
        worst[f"train step, {what}, G = {g}"] = max(
            scaled_err(a, b) for a, b in zip(
                got, fused_train_grads_plain(flat, xt, m, **kw)))
        _one_kernel(torch, lambda: fused_train_grads(flat, xt, m, **kw),
                    device, "fused_ae_train", f"train step, {what}")
        del flat, xt, m, got

        params = grid_params(torch, models, *dims, gen, device,
                             torch.float32)
        n_rows = models * per
        x = (torch.randint(-6, 7, (n_rows, dims[0]), generator=gen) / 4.0
             ).to(device)
        idx = forward_index(torch, "client_major", models, n_rows, gen,
                            device)
        got = fused_forward_stats(params, x, idx)
        if not all(torch.equal(a, b) for a, b in zip(
                got, fused_forward_stats(params, x, idx))):
            raise AssertionError(f"[studies] forward, {what}: not bit-equal "
                                 "to a second call")
        _one_kernel(torch, lambda: fused_forward_stats(params, x, idx),
                    device, "fused_ae_forward", f"forward, {what}")
        sample = torch.arange(models)
        if models > STUDY_PLAIN_MODELS:
            sample = torch.randperm(models, generator=gen)[
                :STUDY_PLAIN_MODELS].sort().values
        sample = sample.to(device)
        remap = torch.full((models,), -1, dtype=torch.int32, device=device)
        remap[sample] = torch.arange(len(sample), dtype=torch.int32,
                                     device=device)
        sub_idx = remap[idx.long()]
        keep = sub_idx >= 0
        sub = {c: {n: {k: v[sample] for k, v in layer.items()}
                   for n, layer in coder.items()}
               for c, coder in params.items()}
        want = fused_forward_stats_plain(sub, x[keep], sub_idx[keep])
        worst[f"forward, {what}, {models} models ({len(sample)} held)"] = \
            max(scaled_err(a[keep], b) for a, b in zip(got, want))
        del params, x, idx, got, want
        if dist is not None:
            n, bank, t = dist
            q, banks, gw = dist_inputs(torch, n, t, bank, dims[2],
                                       "client_major", gen, device,
                                       torch.float32)
            label = f"distances, {what}, {t} rows x {n} banks of {bank}"
            got, _, worst[label] = dist_check(torch, q, banks, gw, label)
            if not torch.equal(got, dist_tiles(q, banks, gw)):
                raise AssertionError(f"[studies] {label}: not bit-equal to "
                                     "a second call")
            _one_kernel(torch, lambda: dist_tiles(q, banks, gw), device,
                        "dist_tiles", label)
    torch.cuda.synchronize()
    bad = {k: v for k, v in worst.items()
           if v > (DIST_TOL if k.startswith("dist") else TOL["f32"])}
    if bad:
        raise AssertionError(f"[studies] kernels vs plain: {bad}")
    log(f"[studies] (f) kernels at the study drivers' widths agree with "
        f"their plain versions and a second call, one CUDA kernel a call: "
        f"{json.dumps(worst)}")
    return worst


def study_cluster(torch, device):
    """(a) cluster_sweep_torch.quick_cell: K = 1 bit-equal to no spec,
    clustered K = 2 at least 0.1 AUC above the single global (the JAX
    package's CPU run: 0.4953), and the serving swap on the K = 2
    federation: no kernel library loaded across it, one forward launch a
    dispatched bucket, each row served by its cluster's model, and the
    swap score-identical where every member holds its cluster's merge."""
    import cluster_sweep_torch as cluster
    with counted_launches(STUDY_LAUNCHES):
        quick = cluster.quick_cell(device)
    serve = quick["serving"]
    log(f"[studies] (a) cluster quick cell {json.dumps(quick)}")
    if not (quick["k1_bit_identical"] and quick["acceptance_met"]):
        raise AssertionError(f"[studies] (a) quick cell {quick}")
    if not (serve["zero_retrace"] and serve["routed_to_cluster_model"]
            and serve["forward_launches_across_swap"]
            == serve["buckets_dispatched"]
            and (serve["routing_parity"]
                 or not serve["members_hold_cluster_merge"])):
        raise AssertionError(f"[studies] (a) serving swap {serve}")
    return quick


def study_drift(torch, device):
    """(b) drift_recovery_sweep_torch's --quick cell (1.5 sigma, mse, 3
    stages): recovered within eps, no ticket dropped, and the frozen
    engine more than 0.1 below the pre-shift AUC (FLYWHEEL_r12: pre
    0.8782, adapted 0.9931, frozen 0.3089)."""
    import drift_recovery_sweep_torch as drift
    with counted_launches(STUDY_LAUNCHES):
        cell = drift.run_cell(1.5, "mse", 3, device=device)
    summary = {k: cell[k] for k in (
        "auc_pre_shift", "auc_final_adapted", "auc_final_frozen",
        "swap_count", "recovered_within_eps", "zero_downtime", "tickets")}
    log(f"[studies] (b) drift quick cell {json.dumps(summary)}")
    if not (cell["recovered_within_eps"] and cell["zero_downtime"]
            and cell["tickets"]["zero_dropped"]
            and cell["auc_final_frozen"] < cell["auc_pre_shift"] - 0.1):
        raise AssertionError(f"[studies] (b) drift cell {summary}")
    return summary


def study_paper(torch, device, shards):
    """(c) paper_check_torch.measure, the quick protocol, one run, on the
    [realdata] phase's published-split Client-* tree: 3 rounds and a best
    round mean above 0.9."""
    import paper_check_torch as paper
    with counted_launches(STUDY_LAUNCHES):
        out = paper.measure(shards, runs=1, quick=True, device=device)
    run = out["runs"][0]
    log(f"[studies] (c) paper check --quick {json.dumps(run)}")
    if run["rounds_run"] != 3 or not run["best_round_mean"] > 0.9:
        raise AssertionError(f"[studies] (c) paper check {run}")
    return out


def study_ablation(torch, device, cfg):
    """(d) quirk_ablation_torch's seven variants at one run each on the
    quick-run config (the synthetic 10-client federation): every final AUC
    finite and at least one round run."""
    import quirk_ablation_torch as ablation
    import sweep_data_torch as sweep
    data, n, _ = sweep.build_data(cfg, 10, device=device)
    runs, ablation.NUM_RUNS = ablation.NUM_RUNS, 1
    try:
        with counted_launches(STUDY_LAUNCHES):
            rows = ablation.ablate(cfg, data, n)
    finally:
        ablation.NUM_RUNS = runs
    summary = [{k: r[k] for k in ("variant", "auc_runs", "rounds_run")}
               for r in rows]
    log(f"[studies] (d) quirk ablation {json.dumps(summary)}")
    if len(rows) != 7 or not all(
            np.isfinite(r["auc_runs"]).all() and min(r["rounds_run"]) >= 1
            for r in rows):
        raise AssertionError(f"[studies] (d) ablation {summary}")
    return summary


def study_parity(torch, device, shards):
    """(e) parity_probe_torch on client 5 of the [realdata] tree: the same
    stop epoch, loss curves within 1e-3 and AUCs within 5e-3 (the JAX
    probe's verdict rule)."""
    import parity_probe_torch as parity
    with counted_launches(STUDY_LAUNCHES):
        out = parity.probe(shards, client=5, device=device)
    log(f"[studies] (e) parity probe: same stop {out['same_stop_epoch']}, "
        f"max |dloss| {out['max_abs_loss_delta']}, |dAUC| "
        f"{out['auc_delta']}, verdict {out['verdict']}")
    if out["verdict"] != "equivalent":
        raise AssertionError(f"[studies] (e) parity probe {out}")
    return out


def phase_studies(torch, device, cfg, shards):
    """The study drivers at reduced grids, each gate one the JAX drivers
    state: the kernels at the drivers' widths first, then (a)-(e), whose
    driver calls are the study path (every launch counter set to 0 before
    each and read after). `shards` is the [realdata] phase's
    published-split tree, removed at the end."""
    t0 = time.perf_counter()
    report = {"kernels": study_kernel_shapes(torch, device)}
    STUDY_LAUNCHES.clear()
    try:
        report["cluster"] = study_cluster(torch, device)
        report["drift"] = study_drift(torch, device)
        report["paper_check"] = study_paper(torch, device, shards)
        report["ablation"] = study_ablation(torch, device, cfg)
        report["parity"] = study_parity(torch, device, shards)
    finally:
        shutil.rmtree(shards, ignore_errors=True)
    report["launches"] = dict(STUDY_LAUNCHES)
    log(f"[studies] study path launches {json.dumps(report['launches'])}")
    for name in ("fused_ae_forward", "fused_ae_train"):
        if report["launches"].get(name, 0) < 1:
            raise AssertionError(f"the study path never launched {name}")
    report["seconds"] = time.perf_counter() - t0
    log(f"[studies] done in {report['seconds']:.1f} s")
    return report


# ---- padding the client axis (phase "padding") ---- #

PADDING_TO = 12            # (a), (b): the 10 gateways padded to 12
PADDING_MESH_N = 9         # (c): N-BaIoT's devices ...
PADDING_MESH_PAD = 10      # ... padded to a multiple of PARALLEL_WORLD
PADDING_TOL = 1e-6         # real params, scale-normalized per leaf
PADDING_MESH_TIE_BREAK = False  # (c): [parallel]'s standard
PADDING_LAUNCHES = {}      # the padded path's launches, by wrapper
PADDING_JOB = "chip_smoke:padding_rank"  # (c)'s rank job


def _leaf_errs(torch, got, want) -> dict:
    """Per leaf of the flat params, the scale-normalized error of the real
    rows `got[:n]` against `want` [n, P]."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    got, want = got[:want.shape[0]].cpu(), want.cpu()
    return {"/".join(path): scaled_err(got[:, off:off + int(np.prod(shp))],
                                       want[:, off:off + int(np.prod(shp))])
            for path, off, shp in ParamLayout(*DIMS).leaves()}


def padding_pair(torch, device, cfg, data, n, what):
    """(a) or (b): run_combination on the `n` gateways unpadded and padded
    to PADDING_TO (the padded run's launches counted), held to each
    other: the same selections, aggregators, verification rows and stop,
    the real params bit for bit or within PADDING_TOL per leaf, the same
    final AUC. Returns (report, padded engine)."""
    from fedmse_tpu_torch.data.stacking import pad_federated_data
    from fedmse_tpu_torch.main import run_combination
    outs = {}
    for pad in (n, PADDING_TO):
        d = _federation_rows(pad_federated_data(data, pad), pad, device)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if pad != n:
                stack.enter_context(counted_launches(PADDING_LAUNCHES))
            out = run_combination(cfg, d, n, "hybrid", "mse_avg", 0)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        outs[pad] = out
    want, got = outs[n], outs[PADDING_TO]
    rows = lambda o: [(r.selected, r.aggregator, r.verification_results)
                      for r in o["rounds"]]  # noqa: E731
    errs = _leaf_errs(torch, got["engine"].states.params,
                      want["engine"].states.params)
    auc = [float(np.nanmean(o["final_metrics"])) for o in (want, got)]
    rep = {"elections": [r.aggregator for r in want["rounds"]],
           "same_rounds": rows(got) == rows(want),
           "rounds_run": [want["rounds_run"], got["rounds_run"]],
           "params_bits": _bits_equal(
               got["engine"].states.params[:n].cpu().numpy(),
               want["engine"].states.params.cpu().numpy()),
           "worst_leaf": max(errs, key=errs.get),
           "param_err_scaled": max(errs.values()), "auc": auc,
           "pad_rows_finite": bool(torch.isfinite(
               got["engine"].states.params[n:]).all()),
           "seconds": [want["seconds"], got["seconds"]]}
    log(f"[padding] {what}: {n} gateways padded to {PADDING_TO}: the same "
        f"selections, elections {rep['elections']}, verification rows and "
        f"stop ({rep['rounds_run']} rounds): {rep['same_rounds']}; real "
        f"params bit-equal: {rep['params_bits']} (worst leaf "
        f"{rep['worst_leaf']}, {rep['param_err_scaled']:.3e} scaled); final "
        f"AUC {auc[0]:.9f} unpadded, {auc[1]:.9f} padded")
    if not (rep["same_rounds"] and rep["rounds_run"][0]
            == rep["rounds_run"][1] and rep["pad_rows_finite"]
            and rep["param_err_scaled"] <= PADDING_TOL
            and auc[0] == auc[1]):
        raise AssertionError(f"[padding] {what}: {json.dumps(rep)}")
    return rep, got["engine"]


def padding_rank(mesh, tie_break=False):
    """(c) on one rank of the 2-rank gloo launch on the one card: the 9
    gateways padded to PADDING_MESH_PAD through the per-phase engine over
    the mesh (mesh_phase_run), its launches counted, then each kernel at
    the rank's block of the padded axis against its plain version."""
    import torch
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.data.stacking import pad_federated_data
    torch.backends.cuda.matmul.allow_tf32 = False
    qc, data = parallel_quick(torch, ExperimentConfig(), PADDING_MESH_N,
                              tie_break)
    launches = {}
    with counted_launches(launches):
        out, eng = mesh_phase_run(
            torch, phase_quick_config(qc),
            pad_federated_data(data, PADDING_MESH_PAD), mesh, mesh.device)
    return {"rank": mesh.rank, "run": out, "launches": launches,
            "block": eng.block,
            "kernels_vs_plain": mesh_kernel_shapes(
                torch, mesh.device, qc, eng, 64, tag="padding")}


def phase_padding(torch, device, cfg, smi):
    """Padding the client axis trains the unpadded federation (utils/
    seeding.py: the init and the tie-breaks drawn at the real width, the
    pad clients' init keyed by client id): (a) the 10 gateways' fused
    quick run and (b) the per-phase one, each unpadded and padded to 12,
    tie-break on, kNN-scored (padding_pair); (c) 9 gateways on 2 gloo
    ranks of the one card, padded to 10 (padding_rank), against the dense
    9-gateway per-phase run, at [parallel]'s standard, the tie-break off
    (`PADDING_MESH_TIE_BREAK`: the ranks' exact merge sums in rank order,
    Adam amplifies its last bits, and with the tie-break on the third
    round's election flipped; PERF.md §6); (d) each
    kernel at the padded shapes (G = 12 here, a rank's block there)
    against its plain version. The padded runs are the padded path (their
    launches, summed over this process and the ranks)."""
    from fedmse_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    PADDING_LAUNCHES.clear()
    report = {}
    qc, data = parallel_quick(torch, cfg, tie_break=True)
    qc = qc.replace(score_kind="knn", **KNN)
    report["a"], eng = padding_pair(torch, device, qc, data, 10,
                                    "(a) fused")
    report["b"], _ = padding_pair(torch, device,
                                  qc.replace(fused_rounds=False), data, 10,
                                  "(b) per-phase")
    report["d"] = mesh_kernel_shapes(torch, device, qc, eng, 64,
                                     tag="padding")
    mc, mdata = parallel_quick(torch, cfg, PADDING_MESH_N,
                               PADDING_MESH_TIE_BREAK)
    dense, _ = mesh_phase_run(torch, phase_quick_config(mc), mdata, None,
                              device)
    torch.cuda.synchronize()
    workdir = os.path.join(ROOT, "build", "padding_ranks")
    shutil.rmtree(workdir, ignore_errors=True)
    outs = launch.spawn(PARALLEL_WORLD, PADDING_JOB,
                        {"tie_break": PADDING_MESH_TIE_BREAK},
                        backend="gloo", device=device.type, workdir=workdir,
                        timeout_s=600)
    shutil.rmtree(workdir, ignore_errors=True)  # kept after a failure
    ph = outs[0]["run"]
    p1_err = max(_leaf_errs(torch, torch.from_numpy(ph["params1"]),
                            torch.from_numpy(dense["params1"])).values())
    report["c"] = {
        "elections": ph["aggregators"], "dense_elections":
        dense["aggregators"], "blocks": [r["block"] for r in outs],
        "round1_param_err_scaled": p1_err, "auc": ph["auc"],
        "dense_auc": dense["auc"],
        "ranks_agree": all(r["run"]["aggregators"] == ph["aggregators"]
                           and _bits_equal(r["run"]["params"], ph["params"])
                           for r in outs),
        "launches": [r["launches"] for r in outs]}
    log(f"[padding] (c) {PADDING_MESH_N} gateways on {PARALLEL_WORLD} gloo "
        f"ranks of one card, padded to {PADDING_MESH_PAD} (blocks "
        f"{report['c']['blocks']}), per-phase, tie-break "
        f"{'on' if PADDING_MESH_TIE_BREAK else 'off'}: elections "
        f"{ph['aggregators']} (dense unpadded {dense['aggregators']}), "
        f"round-1 params {p1_err:.3e} scaled, AUC {ph['auc']:.6f} (dense "
        f"{dense['auc']:.6f}), launches "
        f"{json.dumps(report['c']['launches'])} ({smi})")
    if not (report["c"]["ranks_agree"]
            and ph["selected"] == dense["selected"]
            and ph["aggregators"] == dense["aggregators"]
            and p1_err <= PADDING_TOL
            and abs(ph["auc"] - dense["auc"]) <= 2e-3):
        raise AssertionError(f"[padding] (c) {json.dumps(report['c'])}")
    report["d_ranks"] = [r["kernels_vs_plain"] for r in outs]
    log(f"[padding] (d) kernels at the padded shapes (G = {PADDING_TO}; "
        f"each rank's block of {PADDING_MESH_PAD}) agree with their plain "
        f"versions and with a second call: {json.dumps(report['d'])} "
        f"{json.dumps(report['d_ranks'])}")
    for r in outs:
        for k, v in r["launches"].items():
            PADDING_LAUNCHES[k] = PADDING_LAUNCHES.get(k, 0) + v
    report["launches"] = dict(PADDING_LAUNCHES)
    log(f"[padding] padded path launches {json.dumps(report['launches'])}")
    for name in ("fused_ae_forward", "fused_ae_train", "dist_tiles"):
        if report["launches"].get(name, 0) < 1:
            raise AssertionError(f"the padded path never launched {name}")
    report["seconds"] = time.perf_counter() - t0
    log(f"[padding] done in {report['seconds']:.1f} s ({smi})")
    return report


# KitNET (models/kitnet.py): a federation in N-BaIoT's layout, 23 statistics
# x 5 damped windows (the benchmark's fleet-500gw-windowed traffic, cut to
# 40 gateways), for the main path's run
KITNET_FLEET = {"gateways": 40, "normal_rows": 3000, "abnormal_rows": 600,
                "stream_stats": (3, 3, 7, 3, 7), "windows": 5}
# the train steps of the 500-gateway cell's cohort (250 clients) and of a
# 10-gateway federation's (5), 12 rows each; the 500-gateway cell's
# evaluation forward: 500 models x 3,000 test rows (1.5M rows)
KITNET_STEPS = (250, 5)
KITNET_EVAL = (500, 3000)


def kitnet_fleet(torch, device):
    """KITNET_FLEET's federation (FederatedData on `device`): a normal row
    x_{j,w} = sqrt(0.9) u_j + sqrt(0.1) eps_{j,w} (the windows of one
    statistic correlated at 0.9), an abnormal row 4 + 2 x (the same);
    40% of the normal rows train, 10% validate, 10% test beside every
    abnormal row, all min-max scaled by the gateway's train rows, in
    batches of 12."""
    from fedmse_tpu_torch.data.stacking import FederatedData
    f = KITNET_FLEET
    n, rows = f["gateways"], f["normal_rows"]
    cols, first = [], 0
    for count in f["stream_stats"]:
        cols += [first + i for _ in range(f["windows"]) for i in range(count)]
        first += count
    stat_of = torch.tensor(cols)
    gen = torch.Generator().manual_seed(SEED + 27)

    def windowed(k):
        u = torch.randn((n, k, first), generator=gen)
        eps = torch.randn((n, k, len(cols)), generator=gen)
        return 0.9 ** 0.5 * u[:, :, stat_of] + 0.1 ** 0.5 * eps

    normal = windowed(rows)
    abnormal = 4.0 + 2.0 * windowed(f["abnormal_rows"])
    tr, va = int(0.4 * rows), int(0.1 * rows)
    train = normal[:, :tr]
    lo = train.amin(dim=1, keepdim=True)
    span = train.amax(dim=1, keepdim=True) - lo

    def scaled(t):
        return ((t - lo) / span).contiguous()

    def batches(t):
        nb = -(-t.shape[1] // 12)
        xb = torch.nn.functional.pad(t, (0, 0, 0, nb * 12 - t.shape[1]))
        mb = (torch.arange(nb * 12) < t.shape[1]).float()
        return (xb.view(n, nb, 12, -1).contiguous(),
                mb.view(1, nb, 12).expand(n, -1, -1).contiguous())

    valid = scaled(normal[:, tr:tr + va])
    test = torch.cat([scaled(normal[:, tr + va:tr + 2 * va]),
                      scaled(abnormal)], dim=1)
    txb, tmb = batches(scaled(train))
    vxb, vmb = batches(valid)
    labels = torch.cat([torch.zeros(va), torch.ones(f["abnormal_rows"])])
    data = FederatedData(
        train_xb=txb, train_mb=tmb, valid_xb=vxb, valid_mb=vmb,
        valid_x=valid, valid_m=torch.ones(n, va), test_x=test,
        test_m=torch.ones(n, test.shape[1]),
        test_y=labels.expand(n, -1).contiguous(),
        dev_x=valid.reshape(-1, len(cols))[:1000].contiguous(),
        client_mask=torch.ones(n))
    return FederatedData(**{k: getattr(data, k).to(device)
                            for k in data.__dataclass_fields__})


def kitnet_models(torch, layout, g, gen, device):
    """g KitNET models on dyadic grids (params k/64 in (-1, 1), statistics
    k/64 with lo < hi), the last with nothing seen (hi < lo)."""
    from fedmse_tpu_torch.models import kitnet
    flat = torch.randint(-63, 64, (g, layout.size), generator=gen) / 64.0
    lo = torch.randint(0, 16, (g, layout.k), generator=gen) / 64.0
    hi = lo + torch.randint(1, 48, (g, layout.k), generator=gen) / 64.0
    stats = torch.cat([lo, hi], dim=1)
    stats[-1] = kitnet.fresh_stats(1, layout, "cpu")[0]
    return flat.to(device), stats.to(device)


def kitnet_main_path(torch, device, cfg):
    """(a): run_combination on KITNET_FLEET, every wrapper's launch
    counter set to 0 just before and read just after."""
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.ops.graphs import WRAPPERS
    data = kitnet_fleet(torch, device)
    n = KITNET_FLEET["gateways"]
    c = cfg.replace(scaler="minmax")
    rows = []

    def on_round(result, sec):
        auc = result.client_metrics
        if not np.isfinite(auc).all():
            raise AssertionError(f"kitnet: AUC not finite: {auc}")
        rows.append({"round": result.round_index + 1,
                     "aggregator": result.aggregator,
                     "mean_auc": float(np.mean(auc)), "seconds": sec})
        log(f"[kitnet] round {result.round_index + 1}: aggregator "
            f"{result.aggregator}, mean AUC {np.mean(auc):.6f}, {sec:.4f} s")

    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = run_combination(c, data, n, "kitnet", "fedprox", 0,
                          on_round=on_round)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    log(f"[kitnet] main path launches {json.dumps(launches)}")
    for name in family_wrappers("kitnet"):
        if launches[name] < 1:
            raise AssertionError(f"the KitNET path never launched {name}")
    for name in family_wrappers("autoencoder"):
        if name not in family_wrappers("kitnet") and launches[name]:
            raise AssertionError(f"the KitNET path launched {name}")
    if launches["adam_update"] != launches["kitnet_train"]:
        raise AssertionError("the KitNET path's updates are not one a "
                             f"train step: {launches}")
    engine = out["engine"]
    fused = engine.fused_round().stats()
    auc = float(np.mean(out["final_metrics"]))
    if auc < 0.9:
        raise AssertionError(f"kitnet: final mean AUC {auc} (the abnormal "
                             "rows lie far outside the min-max range)")
    fmap = engine.layout.feature_map
    log(f"[kitnet] {n} gateways, fedprox: final mean AUC {auc:.6f} in "
        f"{seconds:.2f} s; map of {len(fmap)} autoencoders "
        f"{[len(a) for a in fmap]}, P {engine.layout.size}; epochs "
        f"{fused['epochs_run']}, graphs {json.dumps(fused['graphs'])}")
    return engine.layout, {"rounds": rows, "final_mean_auc": auc,
                           "seconds": seconds, "launches": launches,
                           "feature_map_sizes": [len(a) for a in fmap],
                           "params": engine.layout.size,
                           "fused": fused}


def _kitnet_close(torch, got, want, tol, what):
    """Scale-normalized: max |got - want| / max |want| over the finite
    entries (NaN and the infinities where `want` has them)."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)) or \
            not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"{what}: NaN or inf where the plain twin "
                             "has none")
    ok = torch.isfinite(want)
    err = scaled_err(got[ok], want[ok])
    if err > tol:
        raise AssertionError(f"{what}: {err:.3e} > {tol:g} scale-normalized")
    return err


def kitnet_kernels(torch, device, layout):
    """(b): both KitNET kernels against their plain twins under the run's
    map, each one launch a call, timed per call in a GRAPH_CALLS-call
    graph over GRAPH_CALLS input sets beside the bound of
    benchmark/roofline_kitnet.py, the twins' times beside them."""
    from benchmark import roofline_kitnet
    from fedmse_tpu_torch.ops import kitnet as ops
    fmap = [list(a) for a in layout.feature_map]
    beta = layout.hidden_ratio
    gen = torch.Generator().manual_seed(SEED + 28)
    tol = TOL["f32"]
    rows_out = []
    for s in KITNET_STEPS:
        sets = []
        for _ in range(GRAPH_CALLS):
            flat, stats = kitnet_models(torch, layout, s, gen, device)
            x = (torch.randint(0, 65, (s, 12, layout.dim), generator=gen)
                 / 64.0).to(device)
            m = torch.ones((s, 12), device=device)
            m[min(1, s - 1), 9:] = 0.0
            active = torch.ones(s, dtype=torch.bool, device=device)
            active[0] = False
            sets.append((flat, stats, x, m, active))
        flat, stats, x, m, active = sets[0]
        got_stats, want_stats = stats.clone(), stats.clone()
        before = ops.kitnet_train_grads.launches
        loss, grads = ops.kitnet_train_grads(flat, got_stats, x, m,
                                             layout=layout, active=active)
        if ops.kitnet_train_grads.launches != before + 1:
            raise AssertionError("the KitNET train step is not one launch")
        w_loss, w_grads = ops.kitnet_train_grads_plain(
            flat, want_stats, x, m, layout=layout, active=active)
        errs = {"loss": _kitnet_close(torch, loss, w_loss, tol,
                                      f"KitNET train S={s} loss"),
                "stats": _kitnet_close(torch, got_stats, want_stats, 1e-6,
                                       f"KitNET train S={s} stats")}
        errs["grads"] = max(_kitnet_close(
            torch, grads[:, sl], w_grads[:, sl], tol,
            f"KitNET train S={s} leaf {i}")
            for i, sl in enumerate(layout.slices()))
        at = [0]

        def rotating(sets=sets):
            f, st, xx, mm, act = sets[at[0] % len(sets)]
            at[0] += 1
            ops.kitnet_train_grads(f, st, xx, mm, layout=layout, active=act)

        b_ms, b_by = roofline_kitnet.train_bound(12, s, fmap, beta)
        g_ms = graph_time(torch, rotating, device, 300, b_ms)
        p_ms = cuda_ms(lambda: ops.kitnet_train_grads_plain(
            flat, stats.clone(), x, m, layout=layout, active=active), 20)
        rows_out.append({"name": "kitnet_train", "clients": s, "rows": 12,
                         "errs": errs, **g_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
        log(f"[kitnet] train step S={s} R=12, k={layout.k}, "
            f"P={layout.size}: scale-normalized errs {json.dumps(errs)}; "
            f"one-call graph replay {_graph_text(g_ms)}, plain "
            f"{p_ms:.5f} ms eager, bound {b_ms:.6f} ms ({b_by})")
    models, each = KITNET_EVAL
    rows = models * each
    x = (torch.randint(0, 65, (rows, layout.dim), generator=gen)
         / 64.0).to(device)
    idx = torch.arange(models, dtype=torch.int32,
                       device=device).repeat_interleave(each)
    sets = []
    for _ in range(GRAPH_CALLS):
        flat, stats = kitnet_models(torch, layout, models, gen, device)
        sets.append(layout.tree(flat, stats=stats))
    before = ops.kitnet_forward_stats.launches
    got = ops.kitnet_forward_stats(sets[0], x, idx)
    if ops.kitnet_forward_stats.launches != before + 1:
        raise AssertionError("the KitNET forward is not one launch")
    want = ops.kitnet_forward_stats_plain(sets[0], x, idx)
    errs = {name: _kitnet_close(torch, a, b, tol, f"KitNET forward {name}")
            for name, a, b in zip(("statistic", "loss"), got, want)}
    at = [0]

    def rotating_fwd():
        p = sets[at[0] % len(sets)]
        at[0] += 1
        ops.kitnet_forward_stats(p, x, idx)

    b_ms, b_by = roofline_kitnet.forward_bound(rows, models, fmap, beta)
    g_ms = graph_time(torch, rotating_fwd, device, 20, b_ms)
    p_ms = cuda_ms(lambda: ops.kitnet_forward_stats_plain(sets[0], x, idx),
                   1)
    rows_out.append({"name": "kitnet_forward", "models": models,
                     "rows": rows, "errs": errs, **g_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    log(f"[kitnet] forward {rows} rows of {models} models: scale-normalized "
        f"errs {json.dumps(errs)}; one-call graph replay {_graph_text(g_ms)}"
        f", plain {p_ms:.3f} ms eager, bound {b_ms:.6f} ms ({b_by})")
    return rows_out


def phase_kitnet(torch, device, cfg, smi):
    """KitNET's main path and its two kernels ((a) and (b) above)."""
    t0 = time.perf_counter()
    layout, report = kitnet_main_path(torch, device, cfg)
    report["kernels"] = kitnet_kernels(torch, device, layout)
    log(f"[kitnet] kernels {json.dumps(report['kernels'])}")
    report["seconds"] = time.perf_counter() - t0
    log(f"[kitnet] done in {report['seconds']:.1f} s ({smi})")
    return report


def report_train(torch, device, launches, worst):
    """The train kernel's and its plain version's times and bounds at the
    main path's step shape (5 clients x 12 rows) and at 512 clients."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (cluster_size,
                                                  fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 5)
    layout = ParamLayout(*DIMS)
    rows_out = []
    for what, g, rows, precision in (
            ("train step, main path", 5, 12, "f32"),
            ("train step, main path", 5, 12, "bf16"),
            ("train step, 512 clients", 512, 12, "f32")):
        cdt = torch.bfloat16 if precision == "bf16" else torch.float32
        flat = random_flat(torch, layout, g, gen, device)
        x = torch.randn((g, rows, DIMS[0]), generator=gen).to(device, cdt)
        m = torch.ones((g, rows), device=device)
        kw = dict(layout=layout, shrink_lambda=10.0, compute_dtype=cdt)
        call = lambda: fused_train_grads(flat, x, m, **kw)  # noqa: E731
        k_ms = cuda_ms(call, 500)
        b_ms, b_by = train_bound(rows, g, precision)
        g_ms = graph_time(torch, call, device, 500, b_ms)
        d_ms = device_ms(call, "fused_ae_train_kernel", 100)
        p_ms = cuda_ms(lambda: fused_train_grads_plain(flat, x, m, **kw), 50)
        c = cluster_size(g, DIMS[1])
        rows_out.append({"what": what, "rows": rows, "clients": g,
                         "precision": precision, "cluster_size": c,
                         "ctas": g * c, "ms": k_ms, **g_ms,
                         "device_ms": d_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
        log(f"[report] {what} {precision} G={g} R={rows} ({c} CTAs per "
            f"client, {g * c} CTAs): wrapper call {k_ms:.5f} ms, one-call "
            f"graph replay {_graph_text(g_ms)} (kernel on the device, "
            f"torch.profiler, {d_ms:.5f} ms), plain {p_ms:.5f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
    main = rows_out[0]
    return {
        "name": "fused_ae_train",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/fused_train.cu",
        "replaces": "fedmse_tpu/ops/pallas_ae.py:309 (_train_kernel)",
        "launches": launches,
        "max_abs_err": worst["f32"]["abs"],
        "ms": main["ms"], "graph_ms": main["graph_ms"],
        "graph_ms_below_bound": main.get("graph_ms_below_bound"),
        "graph_ms_calls": main["graph_ms_calls"],
        "graph_ms_calls_below_bound": main.get(
            "graph_ms_calls_below_bound"), "graph_calls": GRAPH_CALLS,
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused loss and "
                        "grads",
        "max_abs_err_by_dtype": {p: worst[p]["abs"] for p in worst},
        "max_scaled_err_by_dtype": {p: worst[p]["scaled"] for p in worst},
        "tolerance_scaled": TOL,
        "shapes": rows_out,
    }


UPDATE_SHAPES = ((5, False), (5, True), (250, False), (250, True))


def update_bound(s: int, p: int, fedprox: bool) -> float:
    """Least time (ms) of the step's update on an H100: params, grads and
    both moments read (and the FedProx anchors), params and moments
    written, f32, plus 16 bytes a row, over HBM bandwidth."""
    return ((8 if fedprox else 7) * s * p * 4 + 16 * s) / PEAK_BYTES * 1e3


def update_inputs(torch, s, p, fedprox, gen, device):
    """(args, kwargs) of one step's update of S rows, every row stepping."""
    params = ((torch.rand((s, p), generator=gen) - 0.5) * 0.2).to(device)
    grads = (torch.randn((s, p), generator=gen) * 1e-2).to(device)
    state = (torch.zeros(s, dtype=torch.int32, device=device),
             torch.zeros((s, p), device=device),
             torch.zeros((s, p), device=device))
    step = torch.ones(s, dtype=torch.bool, device=device)
    prev = params + 1e-2 if fedprox else None
    kw = dict(active=step, loss=torch.ones(s, device=device),
              loss_sum=torch.zeros(s, device=device), prev=prev,
              prox_mu=1e-3)
    return (params, state, grads, 1e-3, step), kw


def epoch_graph_nodes(torch, device, model_type, fedprox):
    """The local-training epoch of 5 of 10 paper-width gateways captured as
    a CUDA graph at two batch counts: {"nodes": {NB: nodes},
    "nodes_per_step", "kernels_per_replay"} (the wrappers' kernels at the
    larger NB). Only LocalTrainer and CapturedBody, so it reads a parent
    tree's epoch graph too."""
    from fedmse_tpu_torch.data import stack_clients, synthetic_clients
    from fedmse_tpu_torch.federation.local_training import LocalTrainer
    from fedmse_tpu_torch.federation.state import init_client_states
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.ops.graphs import CapturedBody
    model = make_model(model_type, *DIMS, 5.0, device=device)
    nodes, kernels = {}, {}
    for n_normal in (1_200, 2_400):
        clients = synthetic_clients(n_clients=10, dim=DIMS[0],
                                    n_normal=n_normal, n_abnormal=300,
                                    seed=SEED)
        dev_x = np.concatenate([c.dev_raw for c in clients])[:2000].astype(
            np.float32)
        data = stack_clients(clients, dev_x, 12, device=device)
        states = init_client_states(model, 10,
                                    torch.Generator().manual_seed(SEED),
                                    device=device)
        trainer = LocalTrainer(model, epochs=2, patience=1, fedprox=fedprox,
                               mu=0.001, lr=1e-3)
        co = trainer.cohort(torch.arange(0, 10, 2, device=device),
                            states.params, data.train_xb, data.train_mb,
                            data.valid_xb, data.valid_mb)
        trainer.begin(co, states.params, states.opt_state,
                      states.prev_global, data.train_xb, data.train_mb,
                      data.valid_xb, data.valid_mb)
        body = CapturedBody(lambda: trainer.epoch(co), device, "epoch")
        body()
        nb = int(data.train_xb.shape[1])
        nodes[nb], kernels = body.nodes, dict(body.kernels)
    (nb1, n1), (nb2, n2) = sorted(nodes.items())
    return {"nodes": nodes, "nodes_per_step": (n2 - n1) / (nb2 - nb1),
            "kernels_per_replay": kernels}


def report_update(torch, device, launches):
    """The step update kernel (csrc/adam_update.cu) at the cells' cohorts
    (5 and 250 rows of the paper's 6,764 parameters, FedProx off and on):
    bit-equal to its plain version in params, moments and count, its time
    per call in a 16-call graph of 16 input sets beside its bound, and on
    one set, the plain version's time (eager and in a 16-call graph), and
    the epoch graph's nodes per step and kernels per replay."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.adam_update import (adam_update,
                                                  adam_update_plain, row_ctas)
    gen = torch.Generator().manual_seed(SEED + 26)
    p = ParamLayout(*DIMS).size
    rows_out = []
    for s, fedprox in UPDATE_SHAPES:
        args, kw = update_inputs(torch, s, p, fedprox, gen, device)
        got = [t.clone() for t in (args[0], *args[1])]
        copies = [t.clone() for t in (args[0], *args[1])]
        adam_update(*args, **kw)
        adam_update_plain(copies[0], copies[1:], *args[2:], **{
            **kw, "loss_sum": kw["loss_sum"].clone()})
        for a, b in zip((args[0], *args[1]), copies):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"update kernel S={s} fedprox="
                                     f"{fedprox}: not the plain bits")
        for t, g in zip((args[0], *args[1]), got):
            t.copy_(g)
        # the time of record: each call of the graph on its own inputs, so
        # that at S = 250 the 16 sets outgrow the L2 and every call reads
        # device memory; "warm" repeats one set, which the L2 holds
        sets = [(args, kw)] + [
            update_inputs(torch, s, p, fedprox, gen, device)
            for _ in range(GRAPH_CALLS - 1)]
        at = [0]

        def rotating():
            a, k = sets[at[0] % len(sets)]
            at[0] += 1
            adam_update(*a, **k)

        call = lambda: adam_update(*args, **kw)  # noqa: E731
        plain = lambda: adam_update_plain(*args, **kw)  # noqa: E731
        b_ms = update_bound(s, p, fedprox)
        g_ms = graph_time(torch, rotating, device, 300, b_ms)
        warm = graph_ms(torch, call, device, 300, GRAPH_CALLS)
        p_ms = cuda_ms(plain, 100)
        p_graph = graph_ms(torch, plain, device, 50, GRAPH_CALLS)
        rows_out.append({"rows": s, "params": p, "fedprox": fedprox,
                         "ctas": s * row_ctas(p), **g_ms,
                         "warm_graph_ms_calls": warm, "plain_ms": p_ms,
                         "plain_graph_ms_calls": p_graph, "bound_ms": b_ms,
                         "roofline": (b_ms / g_ms["graph_ms_calls"]
                                      if g_ms["graph_ms_calls"] else None)})
        log(f"[report] step update S={s} P={p} fedprox={fedprox} "
            f"({s * row_ctas(p)} CTAs): one-call graph replay "
            f"{_graph_text(g_ms)}, one input set (L2-warm) {warm:.5f} ms a "
            f"call, plain {p_ms:.5f} ms eager, "
            f"{p_graph:.5f} ms a call in a {GRAPH_CALLS}-call graph, bound "
            f"{b_ms:.6f} ms (bytes)")
    epochs = {f"{m}/{'fedprox' if f else 'mse_avg'}": epoch_graph_nodes(
        torch, device, m, f) for m, f in (("hybrid", False),
                                          ("autoencoder", True))}
    for what, e in epochs.items():
        log(f"[report] epoch graph {what}: {e['nodes']} nodes at those "
            f"batch counts, {e['nodes_per_step']:.2f} a step, kernels per "
            f"replay {json.dumps(e['kernels_per_replay'])}")
        if e["nodes_per_step"] != 2:
            raise AssertionError(f"the epoch graph {what} runs "
                                 f"{e['nodes_per_step']} nodes a step, not "
                                 "the train kernel and the update")
    main = rows_out[0]
    return {
        "name": "adam_update",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/adam_update.cu",
        "replaces": "none (optax's update was XLA's fusion on the TPU)",
        "launches": launches,
        "graph_ms": main["graph_ms"],
        "graph_ms_calls": main["graph_ms_calls"],
        "graph_calls": GRAPH_CALLS,
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the FedProx term, "
                        "Adam and the loss sum",
        "shapes": rows_out,
        "epoch_graphs": epochs,
    }


def phase_report(torch, device, launches, worst):
    """The forward kernel's wrapper-call time (CUDA events, back to back),
    its one-call graph's replay time (graph_time: CUDA events, a reading
    under the bound flagged), its own device time (torch.profiler, a
    cross-check), its plain version's time, its
    bound and device time over bound at the main path's shapes: the
    evaluation and the two serving buckets, then the training path's own
    launches."""
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain,
                                               tile_plan)
    gen = torch.Generator().manual_seed(SEED + 2)
    shapes = [  # (what, rows, models, precision)
        ("evaluate hybrid, 10 gateways", 70_080, 10, "f32"),
        ("evaluate hybrid, 10 gateways", 70_080, 10, "bf16"),
        ("serve bucket, 10 gateways", 256, 10, "f32"),
        ("serve bucket, 512 gateways gather", 1024, 512, "f32"),
    ]
    # the training path's own launches, client-major: validation (5
    # clients x 1,008 rows), the vote (10 models x 1,000), mse_avg's dev
    # scoring (5 models x 40,000)
    shapes += [("validation", 5_040, 5, "f32"), ("vote", 10_000, 10, "f32"),
               ("dev scoring", 200_000, 5, "f32")]
    rows_out = []
    for what, rows, g, precision in shapes:
        cdt = torch.bfloat16 if precision == "bf16" else torch.float32
        params = random_params(torch, g, *DIMS, gen, device, cdt)
        x = torch.randn((rows, DIMS[0]), generator=gen).to(device=device,
                                                            dtype=cdt)
        idx = torch.randint(0, g, (rows,), generator=gen,
                            dtype=torch.int32).to(device)
        if what.startswith("evaluate"):
            idx = torch.sort(idx).values  # the evaluator's rows are grouped
        elif not what.startswith("serve"):
            idx = torch.arange(g, dtype=torch.int32, device=device
                               ).repeat_interleave(rows // g)
        call = lambda: fused_forward_stats(  # noqa: E731
            params, x, idx, compute_dtype=cdt)
        k_ms = cuda_ms(call, 200)
        b_ms, b_by = bound(rows, g, precision)
        g_ms = graph_time(torch, call, device, 200, b_ms)
        d_ms = device_ms(call, "fused_ae_forward_kernel", 50)
        p_ms = cuda_ms(lambda: fused_forward_stats_plain(
            params, x, idx, compute_dtype=cdt), 5)
        tile, ctas = tile_plan(rows, torch.cuda.get_device_properties(
            device).multi_processor_count)
        rows_out.append({"what": what, "rows": rows, "models": g,
                         "precision": precision, "tile": tile, "ctas": ctas,
                         "ms": k_ms, **g_ms, "device_ms": d_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "x_bound": d_ms / b_ms})
        log(f"[report] {what} {precision} R={rows} G={g} ({tile}-row tiles, "
            f"{ctas} CTAs): wrapper call {k_ms:.5f} ms, one-call graph "
            f"replay {_graph_text(g_ms)} (kernel on the device, "
            f"torch.profiler, {d_ms:.5f} ms, {d_ms / b_ms:.2f}x its bound), "
            f"plain "
            f"{p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by})")
    main = rows_out[0]
    return {"kernels": [{
        "name": "fused_ae_forward",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/fused_ae.cu",
        "replaces": "fedmse_tpu/ops/pallas_ae.py:130 (_kernel)",
        "launches": launches,
        "max_abs_err": worst["f32"]["abs"],
        "ms": main["ms"], "graph_ms": main["graph_ms"],
        "graph_ms_below_bound": main.get("graph_ms_below_bound"),
        "graph_ms_calls": main["graph_ms_calls"],
        "graph_ms_calls_below_bound": main.get(
            "graph_ms_calls_below_bound"), "graph_calls": GRAPH_CALLS,
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused forward "
                        "with its per-row MSE and latent norm",
        "max_abs_err_by_dtype": {p: worst[p]["abs"] for p in worst},
        "max_scaled_err_by_dtype": {p: worst[p]["scaled"] for p in worst},
        "tolerance_scaled": TOL,
        "shapes": rows_out,
    }]}


def main() -> int:
    """Everything up to the [device] line under one handler: an exception
    there (a missing module, nvidia-smi, the config) prints its stage,
    cause and traceback on stdout and propagates, so the exit is
    non-zero. A missing CUDA device returns 2."""
    stage = "imports"
    try:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; this test needs an "
                  "NVIDIA card", file=sys.stderr)
            return 2
        sys.path.insert(0, ROOT)
        from fedmse_tpu_torch.config import ExperimentConfig
        stage = "config"
        t_start = time.perf_counter()
        cfg = ExperimentConfig()
        if (cfg.dim_features, cfg.hidden_neus, cfg.latent_dim) != DIMS:
            raise AssertionError(f"config widths differ from {DIMS}")
        stage = "nvidia-smi"
        smi = smi_line()
        stage = "device"
        log(f"[device] {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s)")
    except Exception as e:
        log(f"[error] {stage}: {type(e).__name__}: {e}")
        log(traceback.format_exc().rstrip())
        raise
    return run(torch, cfg, smi, t_start)


def run(torch, cfg, smi, t_start) -> int:
    """The phases, from the kernels' build on."""
    from fedmse_tpu_torch.data import synthetic_clients
    from fedmse_tpu_torch.ops import native
    from fedmse_tpu_torch.knn import dist_tiles
    from fedmse_tpu_torch.ops.adam_update import adam_update
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.ops.fused_train import fused_train_grads
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    t0 = time.perf_counter()
    built = native.build(native.KERNEL_SOURCES + native.BASELINE_SOURCES
                         + native.HOST_SOURCES)
    log(f"[device] kernels and the host CSV reader built in "
        f"{time.perf_counter() - t0:.2f} s ({json.dumps(built)})")
    for name in native.KERNEL_SOURCES:
        for line in native.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] {name}: {line.strip()}")

    worst = phase_kernels(torch, device)
    worst_train = phase_train_kernels(torch, device)
    clients = synthetic_clients(n_clients=10, dim=DIMS[0], n_normal=10_000,
                                n_abnormal=2_000, seed=SEED)
    # the evaluation's distance launch: every client's test rows, padded
    eval_rows = len(clients) * max(len(c.test_x) for c in clients)
    worst_dist = phase_dist_kernels(torch, device, eval_rows)

    # the main path starts here
    fused_forward_stats.launches = 0
    fused_train_grads.launches = 0
    dist_tiles.launches = 0
    adam_update.launches = 0
    evaluated, knn_eval = phase_evaluate(torch, device, cfg, clients)
    if knn_eval["hybrid/knn/approx/f32"]["test_rows"] != eval_rows:
        raise AssertionError("the evaluation's distance launch is not the "
                             f"{eval_rows} rows phase_dist_kernels held")
    serve = phase_serve(torch, device, cfg, evaluated, smi)
    serve.update(phase_serve_knn(torch, device, cfg, evaluated, smi))
    training, trained, datas, writer, names = phase_train(torch, device,
                                                          cfg, clients)
    data = datas["f32"]
    serve["trained_checkpoint_max_err"] = phase_serve_trained(
        torch, device, cfg, trained, data, writer, names)
    serve["serve_pass_knn_continuous"] = phase_serve_pass(
        torch, cfg, data, writer, names)
    torch.cuda.synchronize()
    launches = {"fused_ae_forward": fused_forward_stats.launches,
                "fused_ae_train": fused_train_grads.launches,
                "dist_tiles": dist_tiles.launches,
                "adam_update": adam_update.launches}
    # ... and ends here
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {name}")
    log(f"[main path] launches {json.dumps(launches)}")
    robust = phase_robust(torch, device, cfg, clients, data)
    cluster = phase_cluster(torch, device, cfg)
    redteam = phase_redteam(torch, device, cfg)
    batch = phase_batch(torch, device, cfg, clients, data, smi)
    tiered = phase_tiered(torch, device, cfg, clients, data, smi)
    flywheel = phase_flywheel(torch, device, cfg, data, writer, names, smi)
    tune = phase_tune(torch, device, cfg, data, writer, names, smi)
    net = phase_net(torch, device, cfg, data, names, smi)
    gateway = phase_gateway(torch, device, smi)
    study_shards = os.path.join(ROOT, "build", "studies-shards")
    shutil.rmtree(study_shards, ignore_errors=True)
    realdata = phase_realdata(torch, device, cfg, smi, keep=study_shards)
    parallel = phase_parallel(torch, device, cfg, smi)
    sweeps = phase_sweeps(torch, device, cfg)
    studies = phase_studies(torch, device, cfg, study_shards)
    padding = phase_padding(torch, device, cfg, smi)
    kitnet = phase_kitnet(torch, device, cfg, smi)
    training["orders"] = phase_train_orders(torch, cfg, datas, len(clients),
                                            training)
    training["fused_hold"] = phase_fused_hold(torch, device, cfg, clients)
    round_profile = profile_round(torch, trained)
    round_profile["pipeline"] = profile_pipeline(torch, trained)
    card_vs_cpu = phase_card_vs_cpu(torch, device, cfg, clients)

    line = phase_report(torch, device, launches["fused_ae_forward"], worst)
    line["kernels"].append(report_train(torch, device,
                                        launches["fused_ae_train"],
                                        worst_train))
    line["kernels"].append(report_dist(
        torch, device, launches["dist_tiles"], worst_dist, eval_rows))
    line["update_kernel"] = report_update(torch, device,
                                          launches["adam_update"])
    for kernel in line["kernels"]:
        kernel["fault_path_launches"] = robust["launches"][kernel["name"]]
        kernel["cluster_path_launches"] = cluster["launches"][kernel["name"]]
        kernel["redteam_path_launches"] = redteam["launches"][kernel["name"]]
        kernel["batch_path_launches"] = batch["launches"][kernel["name"]]
        kernel["tiered_path_launches"] = tiered["launches"][kernel["name"]]
        kernel["tiered_dense_keyed_launches"] = \
            tiered["dense_keyed"]["launches"].get(kernel["name"], 0)
        kernel["flywheel_path_launches"] = \
            flywheel["launches"][kernel["name"]]
        kernel["net_path_launches"] = net["launches"][kernel["name"]]
        kernel["gateway_path_launches"] = \
            gateway["launches"][kernel["name"]]
        kernel["parallel_path_launches"] = \
            parallel["launches"].get(kernel["name"], 0)
        kernel["realdata_path_launches"] = \
            realdata["launches"][kernel["name"]]
        kernel["sweep_path_launches"] = \
            sweeps["launches"].get(kernel["name"], 0)
        kernel["study_path_launches"] = \
            studies["launches"].get(kernel["name"], 0)
        kernel["padding_path_launches"] = \
            padding["launches"].get(kernel["name"], 0)
    line["robust"] = robust
    line["cluster"] = cluster
    line["redteam"] = redteam
    line["batch"] = batch
    line["tiered"] = tiered
    line["flywheel"] = flywheel
    line["tune"] = tune
    line["net"] = net
    line["gateway"] = gateway
    line["parallel"] = parallel
    line["realdata"] = realdata
    line["sweeps"] = sweeps
    line["studies"] = studies
    line["padding"] = padding
    line["kitnet"] = kitnet
    line["evaluate_knn"] = knn_eval
    line["serving"] = serve
    line["training"] = training
    line["card_vs_cpu_param_err"] = card_vs_cpu
    line["round_profile"] = round_profile
    line["watched"] = WATCHED
    shutil.rmtree(writer.root, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json_line(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
