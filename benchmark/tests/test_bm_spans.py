"""The per-layer metrics that read the program's own spans: what no span
names (`unsectioned_ms`), the Gibbs call's sweep kernels
(`sweep_kernels_ms`) and the rest of the call (`sweep_glue_ms`), on
hand-made records and in a traced run of the tiny cell on the CPU, where
the two device-time readers find nothing to read."""
import pytest

from benchmark.harness import run_cell
from benchmark.manifest import Manifest

from conftest import ROOT, TINY

NAMES = ("unsectioned_ms", "sweep_kernels_ms", "sweep_glue_ms")


def _read(name, host_s=None, device_s=None, batches=2):
    mod = Manifest(ROOT).metric_module(name)
    return mod.read({"platform": "gpu", "batches": batches, "host_s": host_s or {},
                     "device_s": device_s or {}})


def test_the_readers_on_hand_made_records():
    host = {"impute": 10.0, "impute.self": 0.3, "inputs_build": 1.0}
    dev = {"gibbs:sweep_kernel": 4.0, "sweep.fwd": 2.5, "sweep.bwd": 0.5, "fb:kernel": 1.0}
    assert _read("unsectioned_ms", host_s=host) == pytest.approx(150.0)
    assert _read("sweep_kernels_ms", device_s=dev) == pytest.approx(1500.0)
    assert _read("sweep_glue_ms", device_s=dev) == pytest.approx(500.0)


@pytest.mark.parametrize("name", NAMES)
def test_the_readers_find_nothing_where_the_program_has_no_spans(name):
    # the parent of the spans: the engine's sections alone, host and device
    host = {"inputs_build": 1.0, "vcf:write": 2.0}
    dev = {"gibbs:sweep_kernel": 4.0, "fb:kernel": 1.0}
    assert _read(name, host_s=host, device_s=dev) is None
    assert _read(name) is None


def test_the_glue_needs_the_gibbs_section():
    assert _read("sweep_glue_ms", device_s={"sweep.fwd": 1.0, "sweep.bwd": 1.0}) is None


def test_the_entries_list_both_cells_and_read_spans():
    man = Manifest(ROOT)
    cells = [c["name"] for c in man.data["workloads"]]
    for m in man.data["per_layer"]:
        if m["name"] in NAMES:
            assert m["workloads"] == cells and m["source"] == "program_span"
            assert m["moves"] == "samples_per_s" and m["unit"] == "ms/batch"
            mod = man.metric_module(m["name"])
            assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])


def test_a_traced_run_on_the_cpu_reads_the_host_span_alone(tiny_root):
    res = run_cell(tiny_root, TINY, 4_000_000_017, 0.0, True, device="cpu")
    got = res["metrics"]
    assert got["unsectioned_ms"]["value"] >= 0 and got["unsectioned_ms"]["unit"] == "ms/batch"
    assert "sweep_kernels_ms" not in got and "sweep_glue_ms" not in got
    assert res["correct"], res["checks"]
