"""The sharded compress's host stages run once, on the axis's root.

``FFCz.compress`` of a ``ShardedField`` is a collective call; the base
compressor, the float64 polish, ENCODE and verification run on rank 0
alone, as the reference's one process runs them, and the other ranks hold
a slab at a time.  One module-scoped fixture spawns gloo ranks of
``_torch_ranks.body_root`` at world sizes 1, 2 and 3 at once; each rank
counts those stages' calls (and the decode of ``decompress_sharded``),
digests its blob, and measures its host peak (tracemalloc) over a 64^3
compress.  Every rank returns the same blob, whose payload equals the
world-size-1 payload byte for byte.  A second fixture runs
``_torch_ranks.body_slow_root``: a root whose host stages outlast the
field group's timeout, for which the other ranks wait on the host channel.
"""

import math

import pytest

import _torch_ranks as ranks

WORLDS = (1, 2, 3)
STAGES = ("base", "polish", "encode", "verify")


@pytest.fixture(scope="module")
def root_runs(tmp_path_factory):
    return ranks.run_worlds("root", WORLDS, tmp_path_factory.mktemp("root"), timeout=300)


def _ranks(results, world):
    got = results[world]
    assert isinstance(got, list), got
    return got


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ranks.ROOT_CASES, ids=str)
def test_host_stages_run_once_on_the_root(root_runs, case, world):
    for rank, r in enumerate(_ranks(root_runs, world)):
        want = 1 if rank == 0 else 0
        assert r["compress"][case]["calls"] == {k: want for k in STAGES}, f"rank {rank}"


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("case", ranks.ROOT_CASES, ids=str)
def test_every_rank_returns_the_world_one_blob(root_runs, case, world):
    """The same blob on every rank, its payload (the blob without the pad
    section an uneven decomposition adds) byte for byte world size 1's."""
    (one,) = _ranks(root_runs, 1)
    want = one["compress"][case]
    assert min(want["margins"]) >= 0
    got = _ranks(root_runs, world)
    for rank, r in enumerate(got):
        assert r["compress"][case]["digest"] == got[0]["compress"][case]["digest"], f"rank {rank}"
        assert r["compress"][case]["payload_digest"] == want["payload_digest"], f"rank {rank}"
        assert r["compress"][case]["margins"] == want["margins"], f"rank {rank}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ranks.ROOT_CASES, ids=str)
def test_decompress_sharded_decodes_once_on_the_root(root_runs, case, world):
    for rank, r in enumerate(_ranks(root_runs, world)):
        got = r["decode"][case]
        assert got["decodes"] == (1 if rank == 0 else 0), f"rank {rank}"
        assert got["bitwise"], f"rank {rank}: the slab is not decompress's, scattered"


@pytest.mark.parametrize("world", WORLDS[1:])
def test_only_the_root_holds_the_field_on_its_host(root_runs, world):
    """The other ranks' host peak over a 64^3 compress stays under three
    float64 slabs; the root's holds the whole field in float64."""
    (one,) = _ranks(root_runs, 1)
    slab = math.ceil(ranks.PEAK_SHAPE[0] / world) * math.prod(ranks.PEAK_SHAPE[1:]) * 8
    for rank, r in enumerate(_ranks(root_runs, world)):
        peak = r["peak"]
        assert peak["slab_f64"] == slab and peak["digest"] == one["peak"]["digest"]
        if rank == 0:
            assert peak["bytes"] >= peak["field_f64"]
        else:
            assert peak["bytes"] < 3 * slab, f"rank {rank} peaked at {peak['bytes']} bytes"


@pytest.mark.parametrize("world", WORLDS)
def test_a_root_failure_reaches_every_rank(root_runs, world):
    for r in _ranks(root_runs, world):
        assert r["root_error"] == "planted base compressor failure"


@pytest.fixture(scope="module")
def slow_root_runs(tmp_path_factory):
    return ranks.run_worlds("slow_root", WORLDS[1:], tmp_path_factory.mktemp("slow_root"), timeout=300)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_the_other_ranks_outwait_a_root_slower_than_the_group_timeout(root_runs, slow_root_runs, world):
    """The root's polish and decode each sleep past the field group's
    timeout first; every rank still returns the world-size-1 blob and its
    slab of the decode."""
    (one,) = _ranks(root_runs, 1)
    want = one["compress"][ranks.ROOT_CASES[0]]["payload_digest"]
    for rank, r in enumerate(_ranks(slow_root_runs, world)):
        assert r["payload_digest"] == want, f"rank {rank}"
        assert r["bitwise"], f"rank {rank}"
        assert r["waited"] > ranks.SLOW_ROOT_SLEEP > 2 * ranks.SLOW_GROUP_TIMEOUT, f"rank {rank}"
