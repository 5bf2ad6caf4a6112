"""The random streams of one (model_type, update_type, run) combination
(port of fedmse_tpu/utils/seeding.py::ExperimentRngs).

  * `data_rng`   numpy Generator seeded with data_seed: device sampling,
                 row shuffles and dev-set sampling, run-independent;
  * `select_rng` python Random(data_seed + 7919 (run + 1)): the per-round
                 client selection;
  * `generator`  a CPU torch.Generator seeded with run * run_seed_stride
                 (987654321 for run 0): the real clients' model init and
                 vote tie-breaks (per voter call on the per-phase path;
                 `vote_draws` for a chunk of fused rounds below the
                 tie-break's size rule; above it no tie-break is drawn
                 here: `keyed_uniform_row`).

The first two are the JAX package's streams exactly, so data splits and
client selections are the same draws there and here. The third replaces
the JAX key stream; its numbers differ from jax.random's by design.

The fault streams (chaos masks, the elastic membership timeline, attack
noise, the red team's coalition and poison noise) are domain-separated like the JAX package's `chaos_key` /
`elastic_key`: each is a pure function of (run seed, stream tag, the ids
of one draw), drawn through `stream_rng`, and none of them touches
`generator`, `select_rng` or `data_rng`. So turning a fault on leaves the
init, selection and tie-break draws bit-identical. A draw keyed on an
absolute round t and an absolute client i depends on nothing else, so
padding the client axis or chunking the schedule cannot change it.

Padding cannot change the init or the tie-breaks either: `generator`
draws them at the REAL width only (the real clients' init, then
`vote_draws(..., clients=n_real, width=n_pad)`), so a run padded to a
multiple of the ranks draws exactly what the unpadded run draws, and the
draws of an unpadded run are what they always were. The pad rows' init
comes from a keyed stream of its own (`init_pad_key`, one draw per
absolute pad client: models/autoencoder.init_pad_params), and a pad
column's tie-break uniform is 0.5, a factor of exactly 1 (a pad client
is never a candidate).

`make_run_rngs` gives the R runs of a combination their streams, each
exactly the sequential driver's run r (federation/batched.py).

`keyed_uniform_row` is a stateless tie-break stream for elections whose
[voters, clients] sheet would not fit (federation/voting.py's size rule,
`keyed_tie_break`): voter v's uniform for absolute client i at absolute
round t is a counter-based hash of (run seed, stream tag, t, v, i),
computed on the device for the one voter an election reads. It consumes
nothing, so prefetch, rewind, resume and padding cannot shift it, and the
CPU and the card give the same bits (integer ops only). This mirrors the JAX
package's rule of `fold_in` per voter, then per absolute client;
`keyed_uniform_row_np` is its numpy twin.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# stream tags: the JAX package's spellings of "CHAO", "ELAS" and "REDT",
# and "ATTA"
CHAOS_STREAM_TAG = 0x4348414F
ELASTIC_STREAM_TAG = 0x454C4153
ATTACK_STREAM_TAG = 0x41545441
REDTEAM_STREAM_TAG = 0x52454454
# "IPAD": the pad clients' init (ExperimentRngs.init_pad_key)
INIT_PAD_STREAM_TAG = 0x49504144
# "VOTE": the keyed vote tie-break (ExperimentRngs.vote_key); "RELE": the
# chaos stream's keyed crash re-election (ExperimentRngs.reelect_key)
VOTE_STREAM_TAG = 0x564F5445
REELECT_STREAM_TAG = 0x52454C45

StreamKey = Tuple[int, int]  # (run seed, stream tag)


def stream_rng(key: StreamKey, *ids: int) -> np.random.Generator:
    """The numpy Generator of one draw of a fault stream: seeded from the
    stream key and the draw's ids only (e.g. a sub-stream, the absolute
    round and the absolute client). Callers keep the number of ids fixed
    within a stream."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(key[0]), int(key[1])] + [int(i) for i in ids])))


_M32 = 0xFFFFFFFF
# MurmurHash3 (x86, 32-bit) constants
_C1, _C2, _C3 = 0xCC9E2D51, 0x1B873593, 0xE6546B64
_F1, _F2 = 0x85EBCA6B, 0xC2B2AE35


def key_words(key: Sequence[int]) -> List[int]:
    """A stream key's ints as 32-bit words, low half then high half each
    (the words keyed_uniform_row hashes)."""
    out: List[int] = []
    for k in key:
        k = int(k)
        out += [k & _M32, (k >> 32) & _M32]
    return out


def _mul32(a, c: int):
    """(a c) mod 2^32 for int64 a in [0, 2^32): two 16-bit halves of c, so
    no product leaves int64 (torch has no uint64)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl32(a, r: int):
    return ((a << r) & _M32) | (a >> (32 - r))


def _absorb(h, w):
    """One 32-bit word into the MurmurHash3 state h (both in [0, 2^32);
    every shift is of a non-negative value, so `>>` is logical)."""
    k = _mul32(_rotl32(_mul32(w, _C1), 15), _C2)
    h = _rotl32(h ^ k, 13)
    return (_mul32(h, 5) + _C3) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def keyed_uniform_row(key: torch.Tensor, round_t: torch.Tensor,
                      voter_pos: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """Voter `voter_pos`'s tie-break uniforms at absolute round `round_t`,
    f32 [..., N]: MurmurHash3 over the words of `key` (key_words of (run
    seed, stream tag, ...), int64 [..., K]: one key per leading index,
    e.g. [R, 1, 1, K] for R runs), the round, the voter's position in the
    selection and each lane's absolute client id `ids` (int64 [N]; low
    and high words), the top 24 bits times 2^-24. A pad lane (id < 0)
    gives 0.5, a factor of exactly 1 (pad_draws). round_t and voter_pos
    are int64 device tensors broadcast against the key's leading shape
    and ids (voter_pos [S, 1] gives the [S, N] sheet); nothing is read on
    the host, so a captured body replays it with whatever its buffers
    hold. Integer ops only: the CPU and the card give the same bits."""
    h = torch.zeros(key.shape[:-1], dtype=torch.int64, device=ids.device)
    for j in range(key.shape[-1]):
        h = _absorb(h, key[..., j])
    h = _absorb(h, round_t & _M32)
    h = _absorb(h, voter_pos & _M32)
    lane = torch.clamp(ids, min=0)
    h = _absorb(h, lane & _M32)
    h = _absorb(h, (lane >> 32) & _M32)
    h = _fmix32(h ^ (4 * (key.shape[-1] + 4)))
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.where(ids >= 0, u, 0.5)


def keyed_uniform_row_np(key: Sequence[int], round_t: int, voter_pos,
                         ids) -> np.ndarray:
    """keyed_uniform_row in numpy uint64 (its twin for the tests): `key`
    the stream key's ints (key_words splits them), `voter_pos` an int or
    an array broadcast against `ids`."""
    m = np.uint64(_M32)

    def mul(a, c):
        return (a * np.uint64(c)) & m

    def rotl(a, r):
        return ((a << np.uint64(r)) & m) | (a >> np.uint64(32 - r))

    def absorb(h, w):
        k = mul(rotl(mul(np.asarray(w, np.uint64), _C1), 15), _C2)
        h = rotl(h ^ k, 13)
        return (mul(h, 5) + np.uint64(_C3)) & m

    words = key_words(key)
    ids = np.asarray(ids, dtype=np.int64)
    lane = np.maximum(ids, 0).astype(np.uint64)
    h = np.uint64(0)
    for w in words:
        h = absorb(h, np.uint64(w))
    h = absorb(h, np.uint64(int(round_t) & _M32))
    h = absorb(h, np.asarray(voter_pos, np.int64).astype(np.uint64) & m)
    h = absorb(h, lane & m)
    h = absorb(h, (lane >> np.uint64(32)) & m)
    h = h ^ np.uint64(4 * (len(words) + 4))
    h = h ^ (h >> np.uint64(16))
    h = mul(h, _F1)
    h = h ^ (h >> np.uint64(13))
    h = mul(h, _F2)
    h = h ^ (h >> np.uint64(16))
    u = (h >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return np.where(ids >= 0, u, np.float32(0.5)).astype(np.float32)


def pad_draws(draws: torch.Tensor, width: Optional[int] = None
              ) -> torch.Tensor:
    """Tie-break uniforms [..., n] padded on the last axis to `width` with
    0.5 (a jitter factor of exactly 1); `draws` itself when no wider."""
    n = draws.shape[-1]
    if width is None or width <= n:
        return draws
    return torch.nn.functional.pad(draws, (0, width - n), value=0.5)


@dataclasses.dataclass
class ExperimentRngs:
    run: int
    data_seed: int = 1234
    run_seed_stride: int = 10000

    def __post_init__(self):
        self.data_rng = np.random.default_rng(self.data_seed)
        self.select_rng = random.Random(self.data_seed + 7919 * (self.run + 1))
        self.generator = torch.Generator().manual_seed(self.run_seed)

    @property
    def run_seed(self) -> int:
        run_seed = self.run * self.run_seed_stride
        return run_seed if run_seed != 0 else 987654321

    def vote_draws(self, rounds: int, voters: int, clients: int,
                   width: Optional[int] = None) -> torch.Tensor:
        """The tie-break uniforms of a chunk of fused rounds, [rounds,
        voters, width] f32 on the CPU: [rounds, voters, clients] from
        `generator` in one draw (`clients` the REAL clients), the columns
        padded to `width` (default `clients`) with 0.5. Round r's voter i
        jitters the scores with [r, i]. The chunk keeps them, so a replay
        after a rewind uses the same draws."""
        return pad_draws(torch.rand((rounds, voters, clients),
                                    generator=self.generator), width)

    def init_pad_key(self) -> StreamKey:
        """The key of this run's pad-client init stream (state.
        init_client_states); calling it consumes nothing."""
        return (self.run_seed, INIT_PAD_STREAM_TAG)

    def vote_key(self) -> StreamKey:
        """The key of this run's keyed vote tie-break (keyed_uniform_row);
        calling it consumes nothing."""
        return (self.run_seed, VOTE_STREAM_TAG)

    def reelect_key(self) -> Tuple[int, int, int]:
        """The key of this run's keyed crash re-election tie-break: the
        chaos key and a re-election tag (keyed_uniform_row); calling it
        consumes nothing."""
        return self.chaos_key() + (REELECT_STREAM_TAG,)

    def chaos_key(self) -> StreamKey:
        """The key of this run's chaos stream (chaos/masks.py); calling it
        consumes nothing."""
        return (self.run_seed, CHAOS_STREAM_TAG)

    def elastic_key(self) -> StreamKey:
        """The key of this run's membership stream (federation/elastic.py);
        calling it consumes nothing."""
        return (self.run_seed, ELASTIC_STREAM_TAG)

    def attack_key(self) -> StreamKey:
        """The key of this run's attack-noise stream (federation/attack.py);
        calling it consumes nothing."""
        return (self.run_seed, ATTACK_STREAM_TAG)

    def redteam_key(self) -> StreamKey:
        """The key of this run's red-team stream (redteam/masks.py,
        redteam/adversary.py); calling it consumes nothing."""
        return (self.run_seed, REDTEAM_STREAM_TAG)

    def state_dict(self) -> dict:
        """The selection and torch streams' positions, JSON-able (a resumed
        run continues them; `data_rng` serves data preparation only)."""
        version, internal, gauss = self.select_rng.getstate()
        return {"select": [version, list(internal), gauss],
                "generator": bytes(
                    self.generator.get_state().numpy()).hex()}

    def load_state_dict(self, state: dict) -> None:
        version, internal, gauss = state["select"]
        self.select_rng.setstate((version, tuple(internal), gauss))
        self.generator.set_state(torch.from_numpy(np.frombuffer(
            bytes.fromhex(state["generator"]), dtype=np.uint8).copy()))


def make_run_rngs(runs: int, data_seed: int = 1234,
                  run_seed_stride: int = 10000) -> List[ExperimentRngs]:
    """One ExperimentRngs per run, as the sequential driver makes run r's
    (main.run_combination): the streams of a batched federation."""
    return [ExperimentRngs(run=r, data_seed=data_seed,
                           run_seed_stride=run_seed_stride)
            for r in range(runs)]
