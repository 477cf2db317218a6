'''
Stateless Sobol quasi-random sequence with per-pixel Cranley-Patterson
rotation.

Reference: ptina_tpu/sampling/sobol.py.  x(n, d) is the XOR of the
direction numbers V[d, b] over the bits b set in gray(n) = n ^ (n >> 1),
a pure function of (sample index, dimension).

The reference reads its direction numbers through scipy's private
`_initialize_v` (Joe-Kuo table).  The port embeds the [32, 31] int32 grid
for the path integrator's 32 dimensions (PATH_DIMS) as a constant instead,
generated once from that same table (bit-reversed so value / 2^31 is the
sample); tests/test_torch_sampling.py asserts it equals the reference grid.
'''

import functools

import numpy as np
import torch

from ptina_tpu_torch.io.encoding import decode_numpy_array
from ptina_tpu_torch.sampling import wanghash, wanghash2, u32_to_unit

__all__ = ['sobol_vgrid', 'sobol', 'sobol_point', 'sobol_block', 'sample_dims',
           'pixel_rotation', 'SKIP', 'SOBOL_BITS', 'MAX_DIMS']

SOBOL_BITS = 31
SKIP = 64  # burn-in matching the reference (ptina/sampling/sobol.py:75)
MAX_DIMS = 32

# encode_numpy_array of the [32, 31] int32 direction-number grid
_VGRID32 = '''<i4|32,31
c-pmBYfzNu6@GTvT|hxUaFrEBS42d-fmb3cekjU{3d>b)%7TE%BCHVv<@RbP)EL{MxzRMyP1H2$#0e
TrH4~E$B@SlNbgh_5)ON#|gr?e{F^w9W_Swm%<Lvmi@64I`;OzT7?>Xl=&v`!pG5{k@qWRG@G&M~H2
>c)2@VKos3$1~cL@TFdb9XD<^jqn-(BD9R68+`$XJ<qFr<J>9?zVEbg}WQLJBho?xjS35idLD+%4Ok
d;7Z~u=gQ`K1UrUirq$AB(UOT>LiaqnQ|Yb;dZK}O{Cz5aUmpVzZRXKxd9+!GiAjdJrv$b0=3!Q9Dw
6B#MgJe7>6PiV(i=msnciA@XVurc-~T^scUq!oO|(U{bYichy9#gw1A{Ywiml9=3DD&;Yl#rMilHP+
a2$$)^nEirZZ1OiQVXJgZ^oa$+brI_70k5Eu)^`Agh5jjDhisQkrzQ{O@~VIDoL&fyPCF`*o;@63Aj
RlPUbw<o%78=|3cuH46)7#WmynhH}c>--i(UAYUoua9MGoXs_#s3t8I*|EK4`KZfuvF$2aFz^et%8t
K{kfTI1rYzK>$Nb8euO(ikVE6T6viJKb?~XVE>3?lfS34PYyPxW1gbBe;7GcaMWXl%Z7CBiI;?=`pR
MxuagTM=UYM9bX%hRWQ=9=cBaJk)^i%Y5UjNY&O}8YZWx+7Adre#NI-85#tVGT1Eo9w*#ihz}dOLWD
~^PrI1Y<U_F}&%j7By%#B8sDGkwQ$0BX=R`J_+3go#>k}E#kPvV0gADZ|O&IkTmek5*-r`}1Pxc!Me
hVFQ}8LPzh@S6kZ^ME}Gq(du2#5%~qfpGjP0?zyr^qk(payCM3tbta_5^BFtS)&g#s`kuiNBXvkorh
PQSeCKi&f%lBL}yC*W3ctKO4@v4GuQHXx|s{9j&ZXlS*w9)o?~<|#QrBC=WU1aunAH|Gj^X|4^378)
X@>pj*b<(_UFrqd7B-PhjT2WGR(W5d7`{qtC!AVm|wbDoAd~_-NUujo}4cyHhHFuWzNZU=?P-94%b+
pZJEHiX%G+eki)dFJ|77Cg-tm1pLx)XuY>x9Z1`T9BA&X_q9mze9Hl-DmfBF$l|_NUFE0=C|Frb^jr
(dZ6ne$|v-B*WG0%c^R>(P54&Yn@46y&ZBbb(r0M9La$3W3dgzK5Hh`BNwxkFZTpSPpmmWTO%BSr3W
v2yp>M(Y<}tRIZM9^cXTW6O|Ev5nBUwgsx4HC{bt@NkV-SVip7bTj`Bp2tGoMNMN#rUJj-z@x>IYyM
FD7sA!i2+Qg)n8S<E9oB^YG1W--sTUXa6)3u_K&$Vp<WB8G%M~#$uCzPM6#eCx)FYWb8@+h`v$m|D5
lb-NiZ8KwE+^{{H=Ai;{)0yV!`DIlt{(EaVQ?)>Lua4~=Fmta`A))DPsQToXN}_H(>aQd5^q&I7D#H
R&ERut!u!76A(h(Wxo3Q?mOn;Q$t_SzF^SmJHidd(r1sidSns98CNFe6qt6ToO*9nMVi?=zLOPoV!x
0Vk{!xdFqapZu>j)9Gr;;x(<jd83d61d0jE7QM0^`C-uorpd+&xREA)sz!jYrqm*HmP*v#)kDA4%-L
e)9if9mKbbAYYsh$3Q5Y7pI`&A0;^9+=BDB%-H@{lW^4NWcm5IM#r!y$%(**fwt<byNMH{%gb`sy!k
?<m!7+|rOFdGHAFB@C4+AExRV^nW#9F(=hrh2mvs=ii=kYqgkyaX1~0C}?$5(;O+O9^rz3H!YmKn=k
CLzH3#<vJS4hXY)(zPD8)sb8FH|R-j+lF_tK~6qyK_$ML?f}OUkc}qkvX=o=kBrgS=5{d#LjM^<m#b
3w;smpTG)N2!q7Gr0q17mrPntg?}Z7XtZ#}O;Iq*9Qd_Z<cRuD`*{hoh170kPeyMPbE$^J&D{eP7XD
0O-)Mp6xn!<A#`8)e2VzUmlI-rGoKRFYkF9fpA0*BgwL7xcp_@-b8vyt*k4W@q-FHSmE$U`SqT2uNK
OVd$vZ~o5G+V{^-&-ms@!tkr_Ha|w!+}g5(wwBoIh|Rg_BF80i+rXOia*jP9AG)ZiE(uDIKa8)0p>u
Qw8VsRWeJK+E-aZ9k>JTyVsb+ca*~!MwZj@M#hAe%fJ}fvuxwt6b*j(@1sSS7}?w@tdtv3^B>_5RXD
a?n9XX<2+pJM$@oF}QQgNk<tRUCOf16I`v*j4dp5D9p>s~)?oepqJLi$l4UO7Pxh*RUV7gEveo<6cQ
^<x9r96UX9(cwtv~az4SMsl-&sdl%=qllnS9E(|dTmDD<w7GkFvN>>CNU+Ca;jzz<O8v2JL@!B^&$W
+oryfsp;5At_h@(&&Sac1Tlmv>FmU}%^Qm8*QAs`HxP6&|j+wPlHCmT;b1dA)N6GH%vj^%UT5#l+5p
ARiRDp4fWW+f!i3n}nfjThZU9!@g@1#nWwm@(<SoTsgW4F;iYy)$rlhB^m^Tsqul<2N%=5bj|G1^Es
Y5mh@APIm%dX)~APk)=eJl;9ThnhImyAIj9iE3lku9XQF4vaP)Rf#eQQVhC4@ycPkoYV{ei1*>~1S&
uHue_4y4NIcU7jc%elrb^AP~zau<x+lb8^DAWKWwbjD8?MKX;<al`^vCD`(8FITBjyJQ=-jo1C+El#
N)Pg%{$@phewMa^xEuU;kF<wjC)OodOQb*dSbsG8oRXWGFRjT$|!H>BsR(W{tzPF_O)ZY%)znvUwAU
|#}cAXa3w;Y0emTyqk+Q@Uxnu^@vFrCn2&)?VM?JviQ;5J|Rb4!bB?UhaKC+e1TM7A!{m}*;fds_2V
Z`aj$_1MqzJHvBVWXv+J@kVlCkmrhH4fM=OKQ-?*xppcCa&`f%=Qu;zA3dsQoKQ`|$HI#FiFUF3RX=
5Ir{48m#{^5*ks80W2WvGaM%&aMm&9u4cN)Cv?f%={ccC7hQ_mG@8|w!<&)2{+9404T<K5=i7-~xq<
k7=neb9`UvL`X%Q;aO$eLts0eW)rF0V=g}M77fO?9QzA`^q-ID#u8TzH^lBz1%I@-(0Tny0=t#xEAU
8s^L9croLIpYl%Ah2Kg~WzK1dg=@Ag-94JRO!I8Nh(!<3tg!1md@0S#_0cVa@i8Fr*mrZA;I+}hg7(
9T)ftsB=G@3-4`kP{Z-=jezy!t!J)8B4v&JWS}6SjlA8(ao-@Y|%9z401raXAR$&@d>y#V{TUht!*m
Q-|2Tz17GGZ^gdn>cqWY=#>Ly3tW+*8`}FiH&*OD?caT%Y};3np*}D6b%uELx7l+)cYl|V&w{Zl)Bp
#+1!CBD4b;<5h65ik=YPt8NN9!<xD}3raj=*IVBT1byD<ewy}ufh15$-F(WXp)sIh93qX)B;^p1m$n
cdT4r<Z8&M|_tR82Xs|d7<Z1k$8glCYk(pZKI}gewjJP-y;4U^5T{TVpKWgLKTep;fT5Ii>RorxLLR
cZTV4HdD|qK-^@^o#uqtm#)sIoXsmczBz8}fm%jc<@!Goix5s(q+~CPMu@L0Bueozh&PmjoIL3UJ_2
8_;$(0aO6QLXqgX>^2BuS6BQ{~7yxgGzS`ULJD$rJMqPLmf)u~tW%wtdd`TN`?GB}otO)|bn^RWF8r
AO2sJZG_1'''


@functools.lru_cache(maxsize=1)
def _vgrid32_np():
    return decode_numpy_array(_VGRID32)


def sobol_vgrid(ndims, device='cpu'):
    '''Direction-number grid [ndims, SOBOL_BITS] int32 (ndims <= 32).
    Unlike the functions that make scenes and films it defaults to the
    host: the grid is a host table, and a device copy is asked for by
    name.'''
    if ndims > MAX_DIMS:
        raise ValueError(f'the embedded Sobol grid holds {MAX_DIMS} '
                         f'dimensions, {ndims} requested')
    return torch.from_numpy(_vgrid32_np()[:ndims].copy()).to(device)


def sobol(index, vgrid):
    '''Sobol points for integer sample indices `index` ([...]) over every
    dimension of vgrid [D, B].  Returns [..., D] float32 in [0, 1).'''
    index = torch.as_tensor(index, device=vgrid.device).to(torch.int64)
    gray = index ^ (index >> 1)
    v = vgrid.to(torch.int64)
    x = torch.zeros(index.shape + (v.shape[0],), dtype=torch.int64,
                    device=vgrid.device)
    for b in range(v.shape[1]):
        bit = ((gray >> b) & 1)[..., None]
        x = x ^ (bit * v[:, b])
    return x.to(torch.float32) * (1.0 / (1 << SOBOL_BITS))


def sobol_point(sample_index, ndims):
    '''The [ndims] Sobol point of one sample index, with the SKIP burn-in,
    as a host numpy float32 array: sobol() for a single index, in numpy
    (~10 us where the torch form takes ~0.5 ms of host time per sample).
    Equal to sobol() bit for bit: the same XOR of direction numbers, one
    round-to-nearest int -> float32 conversion, an exact 2^-31 scale.'''
    if ndims > MAX_DIMS:
        raise ValueError(f'the embedded Sobol grid holds {MAX_DIMS} '
                         f'dimensions, {ndims} requested')
    n = int(sample_index) + SKIP
    gray = n ^ (n >> 1)
    bits = ((gray >> np.arange(SOBOL_BITS)) & 1).astype(bool)
    v = _vgrid32_np()[:ndims, bits].astype(np.int64)
    x = np.bitwise_xor.reduce(v, axis=1) if bits.any() \
        else np.zeros(ndims, np.int64)
    return x.astype(np.float32) * np.float32(1.0 / (1 << SOBOL_BITS))


def sobol_block(sample_index, ndims, device='cpu'):
    '''The [ndims] Sobol point for one sample index, with the SKIP
    burn-in.  Computed on the host (sobol_point, a 32-float point) and
    copied over; to a CUDA device from pinned memory without blocking, so
    the host never waits for the stream once per sample (the caching host
    allocator keeps the pinned block until the copy has run).

    Unlike the functions that make scenes and films it defaults to the
    host: the megakernel reads the point from its launch parameters
    (engine/fused.py:fused_trace_primary), so a card default would add a
    device-to-host copy to every sample.'''
    pt = torch.from_numpy(sobol_point(sample_index, ndims))
    if torch.device(device).type == 'cuda':
        return pt.pin_memory().to(device, non_blocking=True)
    return pt.to(device)


def pixel_rotation(pix_i, pix_j, ndims):
    '''Per-pixel Cranley-Patterson rotation offsets [ndims, ...] in [0, 1],
    dimension-major like the reference.  Constant across sample indices.'''
    base = wanghash2(pix_i, pix_j)
    dims = torch.arange(ndims, dtype=torch.int64, device=base.device)
    dims = dims.reshape((ndims,) + (1,) * base.dim())
    h = wanghash((base[None] + dims * 0x9e3779b9) & 0xFFFFFFFF)
    return u32_to_unit(h)


def sample_dims(sample_index, pix_i, pix_j, ndims, rot=None):
    '''Per-pixel uniforms for one sample: rotated Sobol, [ndims, ...].
    rot: optional precomputed pixel_rotation(pix_i, pix_j, ndims) — pass
    it from per-sample loops, it costs ~10 integer ops per (dim, pixel).'''
    pt = sobol_block(sample_index, ndims, device=pix_i.device)
    pt = pt.reshape((ndims,) + (1,) * pix_i.dim())
    if rot is None:
        rot = pixel_rotation(pix_i, pix_j, ndims)
    return torch.remainder(pt + rot, 1.0)
