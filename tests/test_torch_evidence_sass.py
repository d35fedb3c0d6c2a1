"""scripts/torch_evidence_sass.py on the CPU: its reading of cuobjdump's
listing (the disassembly itself needs the CUDA toolkit)."""

from torch_harness_support import port_script

SASS = port_script("torch_evidence_sass")

LISTING = """
Fatbin elf code:
================
arch = sm_90a
	code for sm_90a
		Function : _ZN12_GLOBAL__N_115table_kernelILi20EEEvPKfP6float2i
        /*0000*/                   FMUL R2, R3, R4 ;               /* 0x0000000403027220 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
		Function : _ZN12_GLOBAL__N_115evidence_kernelILi20ELb0EEEvNS_4ArgsENS_9ConstantsE
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   FFMA R2, R3, c[0x0][0x210], R5 ;
        /*0020*/                   FFMA.FTZ R2, R3, R4, R5 ;
        /*0030*/                   FMUL R2, R3, R4 ;
        /*0040*/                   FADD R2, -R3, R4 ;
        /*0050*/              @!P0 MUFU.RCP R2, R3 ;
        /*0060*/               @P1 BRA `(.L_x_1) ;
        /*0070*/                   LDS R6, [R7] ;
.L_x_1:
        /*0080*/                   FFMA R2, R3, R4, R5 ;
        /*0090*/                   MUFU.EX2 R2, R3 ;
        /*00a0*/                   STS.64 [R1], R2 ;
        /*00b0*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_115evidence_kernelILi20ELb1EEEvNS_4ArgsENS_9ConstantsE
        /*0000*/                   MUFU.LG2 R2, R3 ;
        /*0010*/                   RET.REL.NODEC R20 `(_Z1fv) ;
"""


def test_listing_splits_into_blocks_and_counts_each_class():
    fns = SASS["functions"](LISTING)
    single = fns["_ZN12_GLOBAL__N_115evidence_kernelILi20ELb0EEEvNS_4ArgsENS_9ConstantsE"]
    # a branch ends a block, a label starts one, a predicate is not the opcode
    assert single == [["LDC", "FFMA", "FFMA.FTZ", "FMUL", "FADD", "MUFU.RCP", "BRA"], ["LDS"],
                      ["FFMA", "MUFU.EX2", "STS.64", "EXIT"]]
    rep = SASS["report"](LISTING, 20)
    assert set(rep) == {"single", "pair"}   # table_kernel is not counted
    first, last = rep["single"]   # the LDS-only block has no floating-point work
    assert first == {"block": 0, "FFMA": 2, "FMUL": 1, "FADD": 1, "MUFU.RCP": 1, "MUFU.EX2": 0,
                     "MUFU.LG2": 0, "LDS": 0, "STS": 0, "all": 7}
    assert (last["block"], last["FFMA"], last["MUFU.EX2"], last["STS"], last["all"]) == (2, 1, 1, 1, 4)
    assert rep["pair"] == [{"block": 0, "FFMA": 0, "FMUL": 0, "FADD": 0, "MUFU.RCP": 0,
                            "MUFU.EX2": 0, "MUFU.LG2": 1, "LDS": 0, "STS": 0, "all": 2}]
    assert SASS["report"](LISTING, 16) == {}
