"""chip_smoke.py's reading of ptxas -v reports (phase build), on canned
reports: each kernel's registers, and every ptxas warning with the entry
it is about (the mangled name it quotes, else the entry being compiled)."""

import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMM = ("_ZN41_GLOBAL__N__d0c73da3_9_gemm_long_cu_41da2c3716long_gemm_"
        "kernelILi128ELi2EEEv14CUtensorMap_stS1_NS_8LongArgsE")
ATTN = ("_ZN45_GLOBAL__N__7cf7cbc0_17_attention_long_cu_41da2c37"
        "28long_attention_global_kernelE14CUtensorMap_stPKiP13__nv_bfloat16iif")
REPORT = f"""ptxas info    : 0 bytes gmem
ptxas warning : (C7518) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to program dependence on compiler-inserted \
WG.DP in divergent path in the function '{GEMM}'
ptxas info    : Compiling entry function '{GEMM}' for 'sm_90a'
ptxas info    : Function properties for {GEMM}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '{ATTN}' for 'sm_90a'
ptxas warning : Registers are spilled to local memory in function \
'{ATTN}', 8 bytes spill stores, 8 bytes spill loads
ptxas /tmp/x.ptx, line 9; warning : Unknown option ignored
ptxas info    : Used 168 registers, used 1 barriers
gemm_long.cu(130): warning #177-D: function "st_async" was declared but \
never referenced
"""


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registers_by_entry(smoke):
    assert smoke.ptxas_registers(REPORT) == [
        (GEMM, "Used 96 registers, used 1 barriers"),
        (ATTN, "Used 168 registers, used 1 barriers")]


def test_warnings_by_entry_find_c7518(smoke):
    got = smoke.ptxas_warnings(REPORT)
    assert [entry for entry, _ in got] == [GEMM, ATTN, ATTN]
    assert got[0][1].startswith("(C7518) Potential Performance Loss")
    assert "C7518" not in got[1][1] and got[1][1].startswith("Registers")
    assert got[2][1] == "Unknown option ignored"
    # the front end's warnings are not ptxas'
    assert not any("#177-D" in text for _, text in got)


@pytest.mark.parametrize("report", ["", "ptxas info    : 0 bytes gmem\n"])
def test_a_clean_report_has_no_warning(smoke, report):
    assert smoke.ptxas_warnings(report) == []
    assert smoke.ptxas_registers(report) == []
