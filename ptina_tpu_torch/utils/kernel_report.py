'''
Read what the CUDA toolchain says about the port's kernels: the
registers, stack and spills in an nvcc -Xptxas -v log, and the
instructions of a flat face loop in cuobjdump -sass of a built library.

Used by chip_smoke.py and chip_compare.py, which label the logs and
libraries of two trees alike.  Needs no GPU, no nvcc and no torch; the
SASS reader needs cuobjdump (CUDA toolkit) and returns nothing without
it.
'''

import os
import re
import shutil
import subprocess

__all__ = ['KERNEL_NAMES', 'ptxas_by_kernel', 'sass', 'face_loop_path']

# kernel names as nvcc's log gives them, the longer first ('shade_kernel'
# is inside 'blocked_shade_kernel')
KERNEL_NAMES = ('blocked_shade_kernel', 'blocked_any_kernel',
                'closest_kernel', 'any_flat_kernel', 'shade_kernel',
                'any_kernel', 'path_kernel', 'material_rows_kernel',
                'texel_lanes_kernel', 'texel_keys_kernel')


def _instance(line):
    '''The label of a kernel template's instantiation in an nvcc log line
    (its mangled bool template arguments), or None: kBoxes as 'boxes' or
    'two leaves', path_kernel's kRays as 'rays head'.'''
    m = re.search(r'kernelI((?:Lb\d+E)+)E', line)
    if not m:
        return None
    words = []
    for j, v in enumerate(re.findall(r'Lb(\d+)E', m.group(1))):
        if j == 0:
            words.append('boxes' if v == '1' else 'two leaves')
        elif v == '1':
            words.append('rays head')
    return ', '.join(words) + ': '


def ptxas_by_kernel(log):
    '''{kernel: ptxas resource line} from an nvcc -Xptxas -v log (empty
    when a library was loaded, not built); the instantiations of a kernel
    template share its line, each named: the tree kernels' kBoxes
    (path_kernel, shade_kernel and any_kernel: the tree walk with box
    tests, and the one for tables of at most two leaves) and
    path_kernel's rays head.'''
    out, name = {}, None
    for line in log.splitlines():
        if 'entry function' in line:
            name = next((k for k in KERNEL_NAMES if k in line), None)
            inst = _instance(line)
            if name and inst:
                out[name] = out.get(name, '') + ('; ' if name in out else '') \
                    + inst
            elif name:
                out[name] = ''
        elif name and ('stack frame' in line or 'registers' in line):
            sep = '; ' if out[name] and not out[name].endswith(': ') else ''
            out[name] += sep + line.split(':')[-1].strip()
    return out


def sass(lib_path, kernel):
    '''[(address, instruction)] of one kernel (a substring of its mangled
    name) in cuobjdump -sass of a library; [] without cuobjdump.'''
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, check=False, timeout=120).stdout
    code, inside = [], False
    for line in out.splitlines():
        if 'Function : ' in line:
            inside = kernel in line
        m = re.match(r'\s+/\*([0-9a-f]{4,})\*/\s+([^;]*);', line)
        if inside and m:
            code.append((int(m.group(1), 16), m.group(2).strip()))
    return code


def _branch(ins):
    '''(conditional?, target address) of a BRA instruction, else None.'''
    m = re.match(r'(@!?U?P\w+\s+)?BRA(\.\S+)?\s.*?(0x[0-9a-f]+)$', ins)
    return (bool(m.group(1)), int(m.group(3), 16)) if m else None


def _opcode(ins):
    op = ins.split()[1] if ins.startswith('@') else ins.split()[0]
    return op.split('.')[0]


def face_loop_path(code):
    '''One face's common path through a flat kernel's unrolled face loop:
    (instructions a face, {opcode: count a face}), or None where the loop
    is not found.  The loop is the innermost one (a backward BRA with no
    other inside its body) that holds the most LDS.128; each face loads
    its 16 coefficients with 4, so its faces are its LDS.128 / 4.  The
    path walks the body once from its head to its backward branch: a
    conditional forward branch inside the body is taken (it skips what a
    face guards: the hit work of a face no ray of the thread passes, the
    reciprocal of an invalid pair), one whose target lies outside the body
    is not (a rare path laid out after the loop), and an unconditional
    one is followed.  The loop's own step is shared among the faces.'''
    at = {addr: k for k, (addr, _) in enumerate(code)}
    backs = [(at[b[1]], k) for k, (addr, ins) in enumerate(code)
             if (b := _branch(ins)) and b[1] < addr and b[1] in at]
    inner = [(h, e) for h, e in backs
             if not any(h <= h2 and e2 < e for h2, e2 in backs)]

    def lds(h, e):
        return sum(ins.startswith('LDS.128') for _, ins in code[h:e + 1])
    inner = [(h, e) for h, e in inner if lds(h, e) >= 8 and lds(h, e) % 4 == 0]
    if not inner:
        return None
    h, e = max(inner, key=lambda he: lds(*he))
    faces = lds(h, e) // 4
    counts, k = {}, h
    while k <= e:
        addr, ins = code[k]
        op = _opcode(ins)
        counts[op] = counts.get(op, 0) + 1
        b = _branch(ins)
        if k == e or b is None:
            k += 1
        elif b[1] in at and h < at[b[1]] <= e:
            k = at[b[1]]
        elif b[0]:
            k += 1
        else:
            return None
    n = sum(counts.values())
    return n / faces, {op: c / faces for op, c in counts.items()}
