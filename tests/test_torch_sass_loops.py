"""``signalizer_tpu_torch/tools/sass_loops.py`` on a SASS listing written
out here (the tool's parser, loop finder and chain count; compiling and
dumping need the CUDA toolkit, which the card machine has)."""

import json

from signalizer_tpu_torch.tools import sass_loops

LISTING = """
        Function : _ZN12_GLOBAL__N_14walkEv
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                  /* 0x00000a00ff017b82 */
                                                                                           /* 0x000fe20000000800 */
        /*0010*/                   LDS.64 R4, [R2] ;
        /*0020*/                   FMUL R6, R3.reuse, R8 ;
        /*0030*/                   FSETP.GEU.AND P0, PT, R4, R3, PT ;
        /*0040*/                   FMNMX.NAN R6, R6, R9, !PT ;
        /*0050*/                   FSEL R3, R6, R4, !P0 ;
        /*0060*/               @P0 LOP3.LUT R7, R7, 0x1, RZ, 0xfc, !PT ;
        /*0070*/                   FMUL R6, R3, R8 ;
        /*0080*/                   FSETP.GEU.AND P0, PT, R5, R3, PT ;
        /*0090*/                   FMNMX.NAN R6, R6, R9, !PT ;
        /*00a0*/                   FSEL R3, R6, R5, !P0 ;
        /*00b0*/               @!P1 BRA 0x10 ;
        /*00c0*/                   BRA 0x0 ;
        /*00d0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_15otherEv
        /*0000*/                   EXIT ;
"""


def test_sass_loops_finds_the_inner_loop_and_its_chain(tmp_path, capsys):
    """Two samples of FMUL -> FMNMX.NAN -> FSEL on st, the compare beside
    the multiply: a chain of 6 in an inner loop of 11 instructions; the
    outer loop that holds it and the other function are left out."""
    dump = tmp_path / "walk.sass"
    dump.write_text(LISTING)
    assert sass_loops.main([str(dump), "--from-sass", "--kernel", "walk", "--per", "2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1
    loop = lines[0]
    assert loop["function"] == "_ZN12_GLOBAL__N_14walkEv"
    assert loop["loop"] == ["0x10", "0xb0"]
    assert (loop["instructions"], loop["longest_chain"]) == (11, 6)
    assert (loop["instructions_per"], loop["chain_per"]) == (5.5, 3.0)
    assert loop["ops"]["FSEL"] == 2 and loop["ops"]["FMNMX"] == 2
    assert sass_loops.main([str(dump), "--from-sass", "--kernel", "walk", "--min", "12"]) == 0
    assert capsys.readouterr().out == ""
    assert sass_loops.main([str(dump), "--from-sass", "--kernel", "absent"]) == 1
