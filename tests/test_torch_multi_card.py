"""Multi-card multi-view: ``bevy_terrain_tpu_torch.parallel`` over a process
group of four gloo ranks on the CPU, against the port's one-process
``MultiViewTerrain`` and the JAX package on 4 virtual CPU devices.

One spawn (``parallel.launch.launch``) runs every rank's cases
(tests/torch_multi_card_cases.py, jax-free) while this process builds the
references. The scene is tests/test_torch_multi_view.py's. Both port runs
make their tile loads finish in step (``utils.loading.loads_in_step``), so
they see the same atlas slots frame by frame. Held:

* each view's frame, on its rank and gathered to rank 0, bit-equal to the
  one-process ``MultiViewTerrain``'s (every sum of the exchange adds a
  value to zeros), replicated and sharded;
* the same frames within tests/test_torch_multi_view.py's tolerances of the
  JAX ``MultiViewTerrain``: tile sets exact, heights and positions within
  1e-3 m, uvs within 1e-6;
* the step's audit, read from a profiler trace, against
  tests/test_multi_view.py:92-108: sharded exactly one all-gather (output
  ``4 * F * 4`` bytes) and one reduce-scatter (``F * 32 * 128 * 4``);
  replicated none;
* the group ``fetch_patches_sharded`` bit-equal to the plain gather, with
  one all-reduce; the group ``multi_view_frame_step`` on
  ``entry.sphere_views`` bit-equal to the one-process step and within
  ``JAX_TOL["sphere_near"]`` of the JAX step, auditing to ``{}``; the group
  ``dryrun_multichip`` with the JAX dry run's asserts;
* tools_torch/multi_view_bench.py's structure check (the JAX tool's
  ``--cpu`` check), its ranks run in the same spawn.
"""

import dataclasses
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.config import TerrainViewConfig as JTerrainViewConfig
from bevy_terrain_tpu.parallel import MultiViewTerrain as JMultiViewTerrain
from bevy_terrain_tpu.parallel import hlo_audit
from bevy_terrain_tpu.parallel import multi_view_frame_step as jmulti_view_frame_step
from bevy_terrain_tpu_torch.entry import dryrun_multichip, sphere_views
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.parallel import MultiViewTerrain, launch, multi_view_frame_step
from bevy_terrain_tpu_torch.parallel import collective_audit
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasAttachment
from bevy_terrain_tpu_torch.utils.loading import loads_in_step
from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
from tests import torch_multi_card_cases as cases
from tests.test_multi_view import _make_config, _stream
from tests.test_torch_multi_view import TOL_STAGED, _hold_per_key, _sphere_uniforms
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_spherical_mesh import JAX_TOL
from tools_torch import multi_view_bench

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = cases.N_VIEWS
F = cases.view_config().tile_capacity
MODES = ["replicated", "sharded"]  # and "fused", held to the one-process class only


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' results, started in a thread, the one-process port
    frames, the JAX frames), per atlas mode. The dataset on disk is the JAX
    test's, read by both packages; the structure check's is the tool's."""
    root = tmp_path_factory.mktemp("assets")
    jconfig = _make_config(root)
    sroot = str(tmp_path_factory.mktemp("structure"))
    generate_planar_dataset("terrains/mvs", 3,
                            multi_view_bench.structure_config(sroot).attachments[0], root=sroot)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, cases.cases, N, str(root), sroot, device="cpu")
        pos = cases.positions()
        port, jax_frames = {}, {}
        for mode, (shard_atlas, overrides) in cases.MODES.items():
            mvt = MultiViewTerrain(cases.config(root), list(pos), devices=["cpu"] * N,
                                   view_config=cases.view_config(), queue_capacity=1024,
                                   shard_atlas=shard_atlas, **overrides)
            with loads_in_step(AtlasAttachment):
                outs, frames = cases.stream(mvt, pos)
            port[mode] = (frames, {v: cases.frame_arrays(outs[v]) for v in pos})
            if mode not in MODES:
                continue
            jmvt = JMultiViewTerrain(
                jconfig, list(pos), devices=jax.devices()[:N],
                view_config=JTerrainViewConfig(tile_capacity=F, morph_distance=2.0,
                                               blend_distance=1.0),
                queue_capacity=1024, shard_atlas=mode == "sharded")
            jax_frames[mode] = _stream(jmvt, pos)
        results = [r["result"] for r in ranks.result()]
    return results, port, jax_frames


def _frame(arrays: dict):
    """A frame of numpy arrays as the objects ``_hold_per_key`` reads."""
    part = {p: types.SimpleNamespace(**{k.split(".", 1)[1]: torch.from_numpy(v)
                                        for k, v in arrays.items() if k.startswith(p + ".")})
            for p in ("tiles", "mesh")}
    return types.SimpleNamespace(tile_count=int(arrays["tiles.tile_count"]), **part)


def _bit_equal(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


@pytest.mark.parametrize("mode", MODES + ["fused"])
def test_group_frames_equal_the_one_process_class(run, mode):
    """Replicated and sharded take the staged grid path (the CPU default);
    "fused" the fused mesh kernel's plain version on each rank's store."""
    results, port, _ = run
    frames, want = port[mode]
    for rank, res in enumerate(results):
        got = res[mode]
        assert got["view"] == f"v{rank}" and got["frames"] == frames
        assert got["pallas_sampling"] is (mode == "fused")
        _bit_equal(got["frame"], want[got["view"]], f"{mode} rank {rank}")
    gathered = results[0][mode]["gathered"]
    assert list(gathered) == list(want)
    for v in want:
        _bit_equal(gathered[v], want[v], f"{mode} gathered {v}")


@pytest.mark.parametrize("mode", MODES)
def test_group_frames_match_the_jax_multi_view_terrain(run, mode):
    results, _, jax_frames = run
    counts = []
    for res in results:
        v = res[mode]["view"]
        got = _frame(res[mode]["frame"])
        worst = _hold_per_key(got, jax_frames[mode][v], TOL_STAGED, f"{mode} {v}")
        counts.append(got.tile_count)
        print(f"{mode} {v}: {got.tile_count} tiles, max |rank - JAX| "
              + ", ".join(f"{k} {x:.3e}" for k, x in worst.items()))
    assert len(set(counts)) > 1  # distinct cameras refine differently


@pytest.mark.parametrize("mode", MODES)
def test_group_audit_holds_the_jax_counts(run, mode):
    """tests/test_multi_view.py:92-108 on every rank; the host phase's
    broadcasts (header and blobs, at least) are apart."""
    results, _, _ = run
    for res in results:
        stats = res[mode]["audit"]
        if mode == "sharded":
            assert set(stats) == {"all-gather", "reduce-scatter"}, stats
            assert stats["all-gather"] == {"count": 1, "bytes": N * F * 4}
            assert stats["reduce-scatter"] == {"count": 1, "bytes": F * 32 * 128 * 4}
        else:
            assert stats == {}, stats
        host = res[mode]["host_stats"]
        assert set(host) == {"collective-broadcast"} and host["collective-broadcast"]["count"] >= 2


@pytest.mark.parametrize("mode", MODES)
def test_group_views_share_one_atlas(run, mode):
    """Rank 0 keeps the one residency table; each rank holds the whole
    store (replicated) or its slot-major shard."""
    results, _, _ = run
    first = results[0][mode]
    assert 0 < first["resident"] <= first["requested"]  # deduplicated across views
    n_blocks = first["n_blocks"]
    assert n_blocks == 64 * 84
    for rank, res in enumerate(results):
        if mode == "sharded":
            assert res[mode]["store"] == (n_blocks // N, 32, 128)
            assert res[mode]["first_block"] == rank * n_blocks // N
        else:
            assert res[mode]["store"] == (n_blocks, 32, 128) and res[mode]["first_block"] is None
        assert "gathered" not in res[mode] or rank == 0


def test_group_fetch_patches_sharded_is_the_plain_gather(run):
    results, _, _ = run
    blocks, ids = cases.fetch_inputs()
    want = ps.fetch_patches(torch.from_numpy(blocks), torch.from_numpy(ids)).numpy()
    for res in results:
        assert res["fetch"]["patches"].tobytes() == want.tobytes()
        assert res["fetch"]["audit"] == {"all-reduce": {"count": 1, "bytes": want.nbytes}}


def test_group_multi_view_frame_step_matches(run):
    """Rank r's view of ``entry.sphere_views`` bit-equal to view r of the
    one-process step, and within ``JAX_TOL["sphere_near"]`` of the JAX
    step; the step audits to ``{}``."""
    import __graft_entry__ as g
    from bevy_terrain_tpu import math as jmath
    from bevy_terrain_tpu.ops import tile_tree as jtile_tree
    from bevy_terrain_tpu.ops.params import make_frame_uniforms as jmake

    results, _, _ = run
    cfg, u, slab = sphere_views(N, device="cpu")
    one = multi_view_frame_step(["cpu"] * N, cfg, u, slab)
    jcfg, _, jslab = g._build(tile_capacity=128, queue_capacity=512, lod_count=4, grid_size=4)
    ju = _sphere_uniforms(jmake, jtile_tree, jmath.TerrainModel,
                          jmath.TerrainModelApproximation, JTerrainViewConfig, jcfg.lod_count)
    jpos, jheights, jcounts = (np.asarray(x) for x in jmulti_view_frame_step(
        jax.devices()[:N], jcfg, ju, jslab))
    h_tol, p_tol, _ = JAX_TOL["sphere_near"]
    for rank, res in enumerate(results):
        positions, heights, counts = res["sphere"]["step"]
        assert res["sphere"]["audit"] == {}
        assert positions.shape[0] == 1
        for got, want in zip((positions, heights, counts), one):
            assert got[0].tobytes() == want[rank].numpy().tobytes()
        n = int(counts[0])
        assert n == int(jcounts[rank]) > 0
        assert np.abs(heights[0, :n] - jheights[rank, :n]).max() <= h_tol
        assert np.abs(positions[0, :n] - jpos[rank, :n]).max() <= p_tol


def test_group_dry_run_holds_the_jax_asserts(run):
    """The group dry run's tile counts are the one-device dry run's (which
    tests/test_torch_entrypoints.py holds to the JAX dry run's), its
    sharded step audits to one all-gather and one reduce-scatter of the
    dry run's capacity, the replicated and spherical steps to none."""
    results, _, _ = run
    want = dryrun_multichip(N, device="cpu")
    cap = 128
    for rank, res in enumerate(results):
        got = res["dryrun"]
        for key in ("sharded_tiles", "replicated_tiles"):
            assert got[key] == want[key], key
        assert got["spherical_tiles"] == [want["spherical_tiles"][rank]]
        assert got["audits"]["sharded"] == {
            "all-gather": {"count": 1, "bytes": N * cap * 4},
            "reduce-scatter": {"count": 1, "bytes": cap * 32 * 128 * 4}}
        assert got["audits"]["replicated"] == {} and got["spherical_audit"] == {}
        assert "production" not in got["audits"]  # the cards only


def test_multi_view_bench_structure_check_on_the_group(run, capsys):
    """tools_torch/multi_view_bench.py --cpu's structure check (the JAX
    tool's): every rank audits the same steps, the sharded-atlas one with
    its all-gather + reduce-scatter fetch, the replicated one none."""
    results, _, _ = run
    found = multi_view_bench.report_structure([r["structure"] for r in results])
    out = capsys.readouterr().out
    print(out)
    for row in ("sharded-atlas: collectives", "replicated-atlas: NO cross-device collectives"):
        assert row in out, row
    assert found["replicated-atlas"] == {}
    assert sorted(found["sharded-atlas"]) == ["all-gather", "reduce-scatter"]


def test_launch_raises_when_a_rank_fails():
    """A rank's exception ends the launch with an error: nothing is caught."""
    with pytest.raises(Exception, match="rank 1 fails"):
        launch(cases.fail_on_rank_one, 2, device="cpu")


def test_launch_needs_its_cards():
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="cards"):
        launch(cases.fail_on_rank_one, 4)
    with pytest.raises(ValueError):
        launch(cases.fail_on_rank_one, 2, device="mps")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ici_bytes_and_format_are_the_jax_functions(n):
    stats = {"all-gather": {"count": 1, "bytes": n * F * 4},
             "reduce-scatter": {"count": 1, "bytes": F * 32 * 128 * 4},
             "all-reduce": {"count": 2, "bytes": 12345}}
    assert collective_audit.ici_bytes(stats, n) == hlo_audit.ici_bytes(stats, n)
    assert collective_audit.format_stats({}) == hlo_audit.format_stats({})
    assert (collective_audit.format_stats(stats, n).replace("link", "ICI")
            == hlo_audit.format_stats(stats, n))


def test_nccl_kernel_names_key_as_the_collectives():
    def record(name, device="CUDA"):
        return (name, device, 0, [], [])

    records = [record("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"),
               record("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"),
               record("ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)"),
               record("ncclDevKernel_Broadcast_RING_LL(x)"),
               record("nccl:_all_gather_base"),  # the backend's range on the device
               record("ncclDevKernel_AllGather_RING_LL(x)", device="CPU"),
               record("Memcpy DtoD (Device -> Device)"),
               record("mesh_fused_kernel<0>(...)")]
    assert collective_audit.nccl_kernel_counts(records) == {
        "all-gather": 1, "reduce-scatter": 1, "all-reduce": 1, "collective-broadcast": 1}


def test_collective_bytes_from_the_op_or_its_backend_record():
    """Single-tensor ops record their output's shape; list ops are read from
    the backend record that follows (as the NCCL backend names them on the
    card)."""
    records = [("c10d::allreduce_", "CPU", 3, [[], []], ["TensorList", ""]),
               ("c10d::_allgather_base_", "CPU", 1, [[16], [4]], ["int", "int"]),
               ("nccl:_all_gather_base", "CPU", 2, [[4]], ["int"]),
               ("nccl:all_reduce", "CPU", 4, [[5, 3]], ["float"]),
               ("c10d::broadcast_", "CPU", 5, [[]], ["TensorList"]),
               ("nccl:broadcast", "CPU", 6, [[7]], ["double"]),
               ("nccl:all_reduce", "CUDA", 7, [[9]], ["float"])]
    assert collective_audit.collective_stats(records) == {
        "all-gather": {"count": 1, "bytes": 64}, "all-reduce": {"count": 1, "bytes": 60},
        "collective-broadcast": {"count": 1, "bytes": 56}}
    with pytest.raises(ValueError, match="element type"):
        collective_audit.collective_stats([("c10d::_allgather_base_", "CPU", 0, [[2]],
                                            ["c10::Float8_e4m3fn"])])


def test_interpret_and_groups_are_checked(tmp_path):
    config = cases.config(tmp_path)
    with pytest.raises(ValueError, match="interpret"):
        MultiViewTerrain(config, ["a"], devices=[torch.device("cuda", 0)], interpret=True)
    mvt = MultiViewTerrain(config, ["a", "b"], devices=["cpu"] * 2, interpret=True,
                           view_config=cases.view_config(), queue_capacity=1024)
    assert not mvt.cfg.pallas_sampling and mvt.group is None
    material = dataclasses.replace(config, attachments=config.attachments * 2)
    with pytest.raises(NotImplementedError, match="height attachment"):
        MultiViewTerrain(material, ["a"], devices=["cpu"], group=types.SimpleNamespace())
    with pytest.raises(ValueError, match="shard"):
        MultiViewTerrain(config, ["a"], devices=["cpu"], shard_atlas=True,
                         pallas_sampling=True, group=types.SimpleNamespace())
