'''
The toolchain readers of chip_compare.py on the CPU: no GPU, no nvcc and
no cuobjdump needed.

  * importing chip_compare loads neither torch nor the port (a turn's
    worker imports the port of its own tree);
  * ptxas_by_kernel on a canned nvcc -Xptxas -v log: each kernel's
    registers, stack and spills, the instantiations of a kernel template
    (path_kernel's kBoxes and rays head, shade_kernel's two-leaf table)
    each named on its kernel's line, blocked_shade_kernel kept apart from
    shade_kernel, the texel kernels of an anonymous namespace, an unknown
    kernel left out, and nothing for a library that was loaded, not built;
  * sass and face_loop_path on a canned cuobjdump -sass listing (a
    stand-in for the tool's run): the one kernel's code, and one face's
    common path through its face loop (a guarded forward branch taken, a
    branch out of the loop not taken, the loop's step shared among the
    faces); sass returns nothing when cuobjdump is missing.
'''

import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_compare  # noqa: E402

PTXAS_LOG = '''\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5ptina11path_kernelILb1ELb0EEEv15PtinaPathParams' for 'sm_90a'
ptxas info    : Function properties for _ZN5ptina11path_kernelILb1ELb0EEEv15PtinaPathParams
    176 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 1664 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5ptina11path_kernelILb1ELb1EEEv15PtinaPathParams' for 'sm_90a'
ptxas info    : Function properties for _ZN5ptina11path_kernelILb1ELb1EEEv15PtinaPathParams
    184 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, 1664 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5ptina12shade_kernelILb0EEEvNS_11ShadeParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN5ptina12shade_kernelILb0EEEvNS_11ShadeParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5ptina20blocked_shade_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN5ptina20blocked_shade_kernelEv
    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118texel_lanes_kernelEPKlS1_S1_PKflPiS4_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118texel_lanes_kernelEPKlS1_S1_PKflPiS4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 4096 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5ptina11some_helperEv' for 'sm_90a'
ptxas info    : Used 8 registers, 352 bytes cmem[0]
'''

STACK0 = '0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads'


def test_import_needs_no_torch():
    code = ('import sys; import chip_compare; '
            'assert not {"torch", "ptina_tpu_torch"} & set(sys.modules)')
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_ptxas_by_kernel_names_each_instantiation():
    got = chip_compare.ptxas_by_kernel(PTXAS_LOG)
    assert got == {
        'path_kernel':
            'boxes: 176 bytes stack frame, 0 bytes spill stores, 0 bytes '
            'spill loads; Used 128 registers, 1664 bytes cmem[0]; '
            'boxes, rays head: 184 bytes stack frame, 8 bytes spill stores, '
            '8 bytes spill loads; Used 128 registers, 1664 bytes cmem[0]',
        'shade_kernel':
            f'two leaves: {STACK0}; Used 64 registers, 480 bytes cmem[0]',
        'blocked_shade_kernel':
            '96 bytes stack frame, 0 bytes spill stores, 0 bytes spill '
            'loads; Used 72 registers, 440 bytes cmem[0]',
        'texel_lanes_kernel':
            f'{STACK0}; Used 30 registers, 4096 bytes smem, 416 bytes '
            f'cmem[0]'}
    assert chip_compare.ptxas_by_kernel('') == {}


# two faces a trip (8 LDS.128): a guarded reciprocal the path skips, a
# rare exit out of the loop, then the loop's step; another kernel after
SASS_LISTING = '''\
\tcode for sm_90a
\t\tFunction : _ZN5ptina14closest_kernelEv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   MOV R0, RZ ;                          /* 0x000000ff00007202 */
        /*0010*/                   LDS.128 R4, [R0] ;                    /* 0x0000000000047984 */
        /*0020*/                   LDS.128 R8, [R0+0x10] ;               /* 0x0000100000087984 */
        /*0030*/                   LDS.128 R12, [R0+0x20] ;              /* 0x00002000000c7984 */
        /*0040*/                   LDS.128 R16, [R0+0x30] ;              /* 0x0000300000107984 */
        /*0050*/                   FMUL R20, R4, R8 ;                    /* 0x0000000804147220 */
        /*0060*/                   FADD R21, R20, R12 ;                  /* 0x0000000c14157221 */
        /*0070*/               @P0 BRA 0xa0 ;                            /* 0x0000000000000947 */
        /*0080*/                   MUFU.RCP R22, R21 ;                   /* 0x0000001500167308 */
        /*0090*/                   FMUL R23, R22, R16 ;                  /* 0x0000001016177220 */
        /*00a0*/                   LDS.128 R4, [R0+0x40] ;               /* 0x0000400000047984 */
        /*00b0*/                   LDS.128 R8, [R0+0x50] ;               /* 0x0000500000087984 */
        /*00c0*/                   LDS.128 R12, [R0+0x60] ;              /* 0x00006000000c7984 */
        /*00d0*/                   LDS.128 R16, [R0+0x70] ;              /* 0x0000700000107984 */
        /*00e0*/                   FMUL R20, R4, R8 ;                    /* 0x0000000804147220 */
        /*00f0*/              @!P1 BRA 0x140 ;                           /* 0x0000000000008947 */
        /*0100*/                   IADD3 R0, R0, 0x80, RZ ;              /* 0x0000008000007810 */
        /*0110*/                   ISETP.NE.AND P2, PT, R0, 0x400, PT ;  /* 0x000004000000780c */
        /*0120*/               @P2 BRA 0x10 ;                            /* 0xfffffee000002947 */
        /*0130*/                   EXIT ;                                /* 0x000000000000794d */
        /*0140*/                   BRA 0x140;                            /* 0xfffffff000007947 */
\t\t..........

\t\tFunction : _ZN5ptina15any_flat_kernelEv
        /*0000*/                   MOV R0, RZ ;                          /* 0x000000ff00007202 */
        /*0010*/                   EXIT ;                                /* 0x000000000000794d */
'''


@pytest.fixture
def fake_cuobjdump(monkeypatch):
    '''cuobjdump -sass of a library prints SASS_LISTING.'''
    def run(cmd, **kw):
        assert cmd[0] == 'cuobjdump' and cmd[1] == '-sass'
        return types.SimpleNamespace(stdout=SASS_LISTING, returncode=0)
    monkeypatch.setattr(chip_compare.shutil, 'which', lambda name: name)
    monkeypatch.setattr(chip_compare.os.path, 'exists', lambda p: True)
    monkeypatch.setattr(chip_compare.subprocess, 'run', run)


def test_face_loop_path_on_a_listing(fake_cuobjdump):
    code = chip_compare.sass('libdense_cast.so', 'closest_kernel')
    assert len(code) == 21 and code[0] == (0x0, 'MOV R0, RZ')
    assert code[7] == (0x70, '@P0 BRA 0xa0')
    n, counts = chip_compare.face_loop_path(code)
    assert n == 8.0
    assert counts == {'LDS': 4.0, 'FMUL': 1.0, 'FADD': 0.5, 'BRA': 1.5,
                      'IADD3': 0.5, 'ISETP': 0.5}
    flat = chip_compare.sass('libdense_cast.so', 'any_flat_kernel')
    assert [ins for _, ins in flat] == ['MOV R0, RZ', 'EXIT']
    assert chip_compare.face_loop_path(flat) is None


def test_sass_is_empty_without_cuobjdump(monkeypatch):
    exists = os.path.exists
    monkeypatch.setattr(chip_compare.shutil, 'which', lambda name: None)
    monkeypatch.setattr(chip_compare.os.path, 'exists',
                        lambda p: not p.endswith('cuobjdump') and exists(p))
    assert chip_compare.sass('libdense_cast.so', 'closest_kernel') == []
    assert chip_compare.face_loop_path([]) is None
