'''
Stateless Sobol quasi-random sequence with per-pixel Cranley-Patterson
rotation.

Reference: ptina_tpu/sampling/sobol.py.  x(n, d) is the XOR of the
direction numbers V[d, b] over the bits b set in gray(n) = n ^ (n >> 1),
a pure function of (sample index, dimension).

The reference reads its direction numbers through scipy's private
`_initialize_v` (Joe-Kuo table) for any number of dimensions.  The port
embeds a [MAX_DIMS, 31] int32 grid as a constant instead, generated once
from that same table (bit-reversed so value / 2^31 is the sample) and
encoded with io/encoding; tests/test_torch_sampling.py asserts it equals
the reference grid.  MAX_DIMS = 98 covers the path integrator's
2 + 6 max_depth dimensions up to max_depth 16; above it the port raises
where the reference has no cap.
'''

import functools

import numpy as np
import torch

from perfbench.plainref.sampling.encoding import decode_numpy_array
from perfbench.plainref.sampling import wanghash, wanghash2, u32_to_unit

__all__ = ['sobol_vgrid', 'sobol', 'sobol_point', 'sobol_block', 'sample_dims',
           'hash_rotation', 'pixel_rotation', 'SKIP', 'SOBOL_BITS',
           'MAX_DIMS']

SOBOL_BITS = 31
SKIP = 64  # burn-in matching the reference (ptina/sampling/sobol.py:75)
# 2 + 6 max_depth dimensions for max_depth <= 16 (engine/path.py)
MAX_DIMS = 98

# encode_numpy_array of the [MAX_DIMS, 31] int32 direction-number grid
_VGRID = '''<i4|98,31
c-pmkdsvj^_V&$rI6C0SNx%V75KjXlB7(js$arJ~L==<}5fKmu0RcHZWg3+kniZMlXlj%lu&mThuZp
H+HKw^WsXdvyO=UYenVIhWyXWKeyZZRC|NQ2<o=fDJVLfZDd)@0^&pQAl09r0Jmx{}g%bv>)5cvPN4
Q1QNW#FpgO5rNvTF6hgaGU!^?i;vY$Nd!U7jb{#LWuvg@Y51MZRDp7{B#{Zox)ES@zV=Mi)fMfGV*2
MtB$V}zKZx-$k$(N>$vn>)m-Da(rCMY+p*l9&+S^^bQBQF_s{41YjqG&dLFHsM;iy7E)DwA1*ndV#k
l$NkycwPuD%e(U5UF!?&`R!=WaE3$JN%_{{H{9Z3{~zS0h&f*8<v}#qBb{>;v?U0g9^_wM4*q38R(_
aqn`-X=<3CjfDEQCbVBqK-Y8wqMp;^lV8?|H-7M8SjHG(UaLlLVkC-l8{sG=z}dI}cItj9$x&>Vb0y
I>{guW7RzIMVG0(BZd<}4Q5^zw0SgM6Q!yDFXi(z@S3B{Mop|MNEGfwky#bvDcVUw>U&sd<fUaMDIU
R{$@d^xUBV<(kA<D^Zx;__G9wwU{K6>`x}jHc}-ZkxCr&+RO3yKy@m*j53Q=0bdt%1?*$(=q(?Q22|
LD3mnt(MDmku0=Gp*Gi`FY1;T#7wNKc2l+pEGQDt6Vd=K?ZA(i_OQn8TE9PQsF`H``ZC7$TpMHBYEQ
5g7dLVH)aC`zVJP~5TbV!LSU_71)!|*cnOo&2RVmhLZ2OxcTm3Z>CTxmk1+BzjnrREPR{?N!D!uSJ!
E&auBgOcwQ#cx;I_T}~zZqrva%R?0dXchwxP9+>#Ai|eI^6`ZE;c!@%6yWrcN~W^`_Sy<Ksk4N=Do}
FN1Z(Xc9Mgsc>x%E$JLk}hjJTiozEqlQnO!u1Z4Flm*F@T8tfe4sGZyL^`pukV%>|-(jv>n-wylM<x
E|WQiBM-Wq4mfzIA(dkJ}MkeL!!mK+m=Yli`SS(?#(s~&d|3$G`XnDNuxdvH`M}rr<A|gHYr$}tHeB
&wuv)2fH5c5)stzPdFW<-)@1@GMnT-tKniw(@i9-B&aB4a|HQ&Es0Q|rFNDka5n|)d&2oyJ&RpnFXQ
&QLyp-VSvokf=_2a_FR&A|5lh@DhyVMiM#W)M*StjPJ*??sl(8K!g3TIeW0X(;G@rCR>4AzGNpu034
Ik%1II%UGu(#4pl8YFVIM@wDD8;oClwX8S#iz)4w|7^bPESGvYTGx5nTPph1n7@KG+QJ;#9>Q(L-^}
wEh`Y#9Oi2W=Wd)BGO{}>>cAW%kdjkw}gP{-0M^|touKJc^fkUl0vo%+C&hj+6j7#fu8fLg8hQ=3m1
t&)R!*~9^OovtdaDJCtW^&P%V7z4)+UB_|%tQQmhK2F>@dDhJLOfLq>4Y1slhV=YnFxL0NTj%g;+u`
pc>Q97_~1yk>>y7u+MDCl_LfqAhr=OnyL9=LIK7(lj>DCr0XUV|0=X2Sv`uc4$tPNJuc?{&o=)4ug)
`6SFb2Xg3bI`iw3{YCeS9(e_c>zoo6g91$q)am@)D5`mhg|~@sHc{k9+IsOAzG30%#|N!j#`H=C)o!
4gq-^^AuiVU6YZ~#=2@{JW^PHSBd{~H4r~0Ksq-O=AJ-U&W%9vw*@$4sl=%t^r-(^qA*uDOVVQ#v}U
(RwFRDaJ)6q2eoY=0RkSjD-t&)_^y70Ix0ES<lS2gklry-^8n+MwIjp-2todb(!)MMAIZ2Sum%zL%A
HC;hq4o1%bZdrU>XDH+cx;|1y*gOx*5n$e9+{~=cx-7;>D7iY-I_`EQ;&pCIC!ji0KaW9CwHQOw#i>
I`;C?{Hn8SyGWS{JoLjWLu$h#rfxLYgv|l*E<PZV>O#$#YF$O#KufXERL&VC<BP0)pN!lHoma7+^(%
oFSdv%`26Dy;3<oT8^K4I$Tx6L+tCixlUX9(7s%yVh^KGSO2W*(}Yfo9_U^|26_{UA9TV7B*1uR}Oa
yUfOIjK}Qz9Wnak6!E%wrgZzzEaU9UN$Sz4xH<8j!s@qAjn4RP-&FT2Z!`_SYc_6K&$WoQm(n)-rj;
016WjjG$p!YYTg1aLa;jAg+1nM`r-RWsBm;H+ftY)KByQA?K(M`^7__lT+I)Pt_Tsey!%KeCJ8FY{J
mhl;OSDb3E}c#ufARY+ui5w}gp2hjcqW<gu<}futntIle<J(IeCEN9+QBZKI3EL}-AtJ5rl3wt#m-~
3xYww{43kDYn^PkDY;Ll;{qEFzEpb--)AL*SM}lmDWAgm^*)CRM9-?q6ZOX*GmHpg8e(fO^ZZifY<T
^Vih<o&qkA=hhl`|}s0Mzx^Lvv>k_I&4nOnHHrVjL;edb^s>y9W0DIX1K7vwKH5;<lSJO6Iu0uBKoA
E>^H+<CbYkFJV77Qr=lS={IvQcLea|a@x*>ARc6?mbNu8wateA;!xb~uENz#&e+;LOgykjCH?+|hc(
+dL^tB;Id$*-v%nD^!S;C9$pPmU^y4+X!sjtcA4}=0G4o31oB27-I_n}1*0Zl1^MTmy1j#!O+A|?gc
V*)AdUsqn7J+TrWVl<r#2dv8lJ-Kr_R-gtsvmMR_0%q@bCkS;oV90~ozz_p1Jrl8;&&-+GX^p_Kuc~
luy3nq^ExqJluX+zX?r-NHa*PGXQ8ceD*V$U@M2>#eojxr_l@NuW&U{S^~TxS?)252R~kdx(?70pl-
{1>Z2qy#uI&e(0kmS7f^(a0ncY|4X6C<*7^@>buF-dACtzzT1o13gBd={D&e>~<bKH@5NP`Fez6`JY
BS83Ua*;kaG+P&4THSW2W?K8mmITMd>K5k*Tb9_pQd7~d#_sm-3`Hx_XNfXiODy#AT=C3-hB3KH&ij
d2JDd$^VJ?g(*h5(#r|qI}$SxEg2qPvYn?&nwmAt4^V?Ej)VhG+>p-R8C$nnsSQu_}IqMaso`uEGX?
f<sA3si7UK9|XD%pXiVUmee|mzdZ?ZFA6<+>#Gzh&zn8nxI>`7CjEjkwxwMIXUV*yFB4xXD{!wn`M3
Uo~*V%<aMet^B_k}=V0ffIh9V2d{*2~w-hT_8>vh+)Zr5O%}89U$+I2A$8F+0kTF;g4x!J6{L*TeGn
YYqCkg(6)DE0qX6ya&&P!$DolnE0#CIahjeq9$K7-_*ihI^OIwqIef4AJ#<t1;ge)S!x)VIwx`-f=g
vu!5sdS?LboJ}sUHuf+VpLs((>jwG4a%i6ogZjck9DbJNd!ZcJVJ+CYy++*Jppl<h8D||CxT5WH=c?
k(M_jv}S-I|;k%10RT<-MiSKoR?pWEgV;#tslnH*r|ETCiE)saunx&!Yr<{xE1Ol^YfSq1a1co-5rp
kGyvUv;^d|HoVm_n0r#!%F4RcN~pQX;Hmd@`CnV=CNI)qemAw{Sp34mS^Aq`aDk=6=_dUH%Y{|bsag
C{Y%e2{vz%FOkDin2r;+_Ql1^OOTwW0$pw*-Rk)rv51W=mV%ATIqUrezIX@`he0_?a$q5a`4~XQhVb
b*dXO}OknfTMtelhn~VoqD|R`i-J=ER(uToX^9e`P+{EAjd)h=^p!dxK%!l?Jt1gZRTm$a=jV|B9H5
KlUvavAae|N$O~$Io_!)=C`W4)6NAccYducl3dE32>UIpUw!-kMW3fCGcfyym7LN>zjKJWo$P&HJdd
XqVvz~bRu!z5J)rJx#_5XjNa;?%#fl^>{h~qq@h_b;ZD+AH>X9Jbg?U9e`EN`~p{o4mHtM1u_&=EL-
$QLNr#%qQg8V5jqiynl$%b=kxFE*di&}NfNQjX`A$4k?)t5t8HVGZijYEpb4;LewF{pc*Nd8xt92VT
9J?J&Q^V>C1?S&DQT}1~|!&aScc>S9f3;Weryi#N972QJLWxmJEe%;18ziFGth><<)V{1G)8{|M{pE
H_cVA+}m)gM!EJ832U9i~CcOFkm;$|ULOtq#Vqe=P4@msDPyyk~XF?y|K7uQjZC^RnHXezx^WzHPRn
X`BAaoVU&Fp(fT`9kp6F`}z&WXH6l*xaqV#59ZKNs1MfS^d%iMFBT(vOA00(j1l+cILTkG8Dc!~vS;
TW*u`(V$EC~dSY5%y-Fa_rG)?WNks}peD_1l!^C}SsW@;%NaiAx^cd^bx*wbH+f~c*cc4&mwZX|jU4
F7wU;*gYti=m!4X&NCmuO20PA4)TSc%#UYFE!=-5xS;pW#y3lNyT>OOJ1KdfL?1<IMwDi{g-IRNKL6
`Pr1pOf15MOQJ%pr4`OWzBxx~>)@G;;G1N>8(RkehfnhF)ercAt)mbHJ-ia|jqt~ka>`XTgt}T8$U2
;6CHx}91QNjK1yPig+#%$Vwv5;8PMrt+-V-e4q+c^vPhM527YKXTdL$V~pcsL1$?m4L2RE@?-DY)TS
f)<YeVR*MzYCce4e5hcwCF4L?{Dy)#JBtpiE!tf$;knTVy!!c_qs(Kz%51=MNbH|R_U<<JPXA!?8hh
DH)@F?#gglA;yB5ZFKd3jmAZLF*#_X%Y<A+zm^K7IDnwcee)yy{DBMoj#u%!Bz-pn~05EOLEdFs@OB
SwuHz;>B33)=3Ph<S<gsFg7>P`ex^r@YO0kK^xisapakLV7zC#+T!u9_ofm)H7pVT!pwBqp;}r0?}Q
jl~%Z$tlxy`4Qr*?_z}j0+x2SikC$AU;hy(mf1KZ)iF}oNCfmIO>)A~Ib<9H!`F$_rFpfQS-&Cd~n%
ZF|v|cM=`pkfv`dDamGZB}w7@>O;MESV!(&T+p%-?lJ>sIYue`(UVLDwAi&DnCYbJk;dd&dpHskWN8
;h%qBL@4(yHa=%u4s#xfWzEI0*UTFP@sDOm_XWYY#Sf<X2(+IsK=_$BeEGczmG6uYe@_aR+@)n!oiV
yIwRc*4R?d{_nfK|l7j9Ybj$QrQelb@my2a)<d$r)4Dv@8T<TwlYwS&26q@MW~^Zx|rlI?>ay*MAnn
e|YA?|{}@@$hIU!Ht+T$b2GNY}sBZEq>A4T6N0KqCMam`SOm`#M<vOw{+byxTG}1_2X2%V%s){1}k$
Y@owg7V;||D-?#ah4Cd<FWQg8)NM%N7*PCEi=#SI(l)yuZ@L<>^c%IA@`(LP(R(uQd9aC)E>@mwC7c
W`ywrXS3+Di|*O)i{VKfqk#sPH*`6M0I^8T(G2r;d5o(DxGZ>&C?ppQke4D`5Ot1ykrkTsobBl$v7f
nVyK%Qk*C>&X7j;+F6s@lRInohTbgLwjj%J&eiR-#j~btYkEIkv*kNcx#P0kw+!#oYi4qL8~L@B=Q%
{qA4$D9DgffUwU9<Fg!Marm`3^HW=S;Wew&T&W;ej$NUAt<b-k=x8mfKudWa$4P|;D^QFSfi+R!cYw
&Z{0^-=Nwe%ov_)}THT%(KkeGP8GD$Y-t86tS%D1kUGUshKPxkj4hG1e2iqp$>;luJE`s9XE2q(GcJ
x{w$d#hsa^tKy8*fNj<xxF0v-v^;+4s=`q7y!!M`x(@ZLbTWmO|J;C$H9NnzcYX)*!J300OIcGi3x<
U=%$9zxVJT}M&rigrWJm!r&%{ur7u0hi;&EnLL6|#HnB;&@1$F|wSbaNIWQ>G)xJ`HjIbh2^R|GH<&
Q@DkCK`;(7Yud=!yOZ`#^Znt>{ZY;a5i=k*4uj+nODKlH5IzO*N2@S5q68m1<zvK&)#By+V7YjEfz|
crBGcFtb34BK`-JTUS+jpG@<~52_qED?F^^a7G;MljgpzOaxRyPwjd5sYAEhoq9C7|iJjWK+cU2~=x
67al(jdpz4YAWkVaM?%guXIXeD#5o-0+&K`Sb2YhK9|W4r7RJ?(E??Q_p0@zBbPg_+MtCW<@(tJITb
kmi2C8{tvST?qiRAmG6B$8{&c0kdnP&-7p6R(_HA|z0jC41KHcg!SCceu|0aQTzIm`yz^jmXPr}O`{
!FLe@&|y;kM`b<<Y^>p8fJ2`Io!BiOO9M^_h`8tLD%C)KK>^9tn)m3>8FL5G225n4JP(k~L6S^$4=~
qWR`D1Y|h~&GA*T-Y>%X_{Onhrn0)>Shsx<oWcf)lK1W81q0meRVy(cPuo0$On<f1GCJChB)4s6Om3
0$qB#>qtbw#)6y=;N)a+^g+AQ+958NUbA$Yr+P~8fZ-J>U)AA4>}@6s8|R6nFAZANd+2QI47``q`I^
{ek3MYq`W`5L8<Q7dbC9vwBKzYFy_IrS9v%yKt~{WBnaHy7sae5fT4_?z|cFjc`feiR&b+6ycTl!iV
$M|+PPX-N6gRh2ZoVsl#D@KZ<jxR(yTqwk0FyZ7g|`sU0ccm|m~s%4*7b5>|2=UiY8?Ab>r)kAFH?7
y%D)}CS1=e1C^#=!By8o1dPz<W}Xcyz-YIdx&N*;*WIa<YWAx_2aYxppnt<Mp7a#_MZo0IU@%_btPe
`!({YmOVu`p^w)%cY#<!O98~HJjhEYz<41ZYMl!HDh(VpBjFa4iGW9DiTgiklHWfv+gdiiQ8y@eM(a
Ia;OuGVl!Du?<u%=L5d%D{8KdOerkR*$c`UbCXKMc2N}X87T-;!thc1I~SqbUgNwAi!fZAe!ioM3Mu
@Sz_)o`Du6|I$1<@Edp?V1nsOu6r_YW<~bXv#24*;TKO@wuADfoA`3WfrvY8g-h?Ias@t^-X&{#O7w
^;y6DuqzuBN2(rU?7<ZbWo?8Z0!F*^^N8|CX7@QflK$O3cE2%zPXWc$#Xy@@qWAw|b>kHlF{98We*k
@f0Bm3E|Q+ntUWe#;v>YF~d1^3<E?<B|FAlCQIhNv3@`Nt)&ZgGS<Zw6G^8PNQeglBZcI6qt?Zs=x8
ffL=Wt!+iUC#szFzun9&beufl=;keM5nZ!A2H>?uW&Y0WyJwP!F)ewZll}W9YrB!Yk0aj?od)r66g9
FI=Eny^eRdZ7v!@{_VidM)2u1$)#bVUg335trsrLEuY>QoIv3^M1<m+~cCI9yF8oO)Qfua9}&uv(%Q
05X%-#t?s>r7A0ex2tFVeLPW4)Kd4<cW4Lz7+{|<9MhpE`sA*5;o1t#ovAo7XLKY$RGX|V6A$}Pv?E
TPOl0X6z=sz{-+QB67=WsiA(#%yjbx&M47)C7m3){vX8d0u6xL97s%xw)BnHO=8_mlnmTAl#X{{E1C
?_!G>@iX$GHULFIq32(`Cs^{ibUVsO#19@6Xg9xS3O!m6^HT{6@vZl&+!y?iFn{MjiocK#cBt4y<M0
YGaNsQ8Qd1w@qh0?kA`II0ABM0<@F!XnQ(T390bdunapsTZhX%e&WrtN%G|vv#on>*sIU}$6G%kH)w
C*;Iz2y4^NqRqS1eV8p~4V?<Qq7;2dJ6{|5H54!)<6J^x<XJ~M{foPnPh0&PzV)Mp~m+USauC&nPII
2uk5=*70Y!BX!1leMF)3k-h$Sk<xhVxA_mpvvu~H(Vc?`F_9v&&O=_?WOc@`YtmUX4`WE;;)_YXk^^
y6DPT;Y&BVsdtG34u7UcgdbD0mMz^*YH#jQ}jmQuWc~nTB9*D8Fq}1y^Da|Nec`f1B58sNMX>5%7@z
nbz|K*uvpfVfS_1)du^qPe~tH`mAtn&wXrpqo6Q8kdCE``;?UgGMD*02^_crpgxEeV31#Zh>*dQ0ev
G`hV|p$j-Op}5`NFZRL%*;lP=vn$=Zng+OE%TxSL?t2a_b1pE?=+o!^<nwT1|8a6a)e4C6)sSb!z<P
cR)X$Rk)-6Q$nljuvSpygKEa85*Qu6rKXmr{V*Xg#%Q2gl4(T6@sP=C{q6kmTaDy3f!RVlodt;`0t`
&9aBCjNTKEh_f4SmHAwm%610;=Bpc%h9l!vY^hNi+27xYe^Wcmb4&1_7R?D4_VW@+N@SB>2!@v?(jI
8_O?sKsy&bXvMg!wGvfxp`Q7>3v+u4)riM2YZ`1^cAJ#XI74giAM?svP2{~{TjGGdmo;4e-hUqw4J`
U@1$}p(9MtFT$CJjomw{G;BY&!PnsGeVMIRAQaQrfuQHn+<s%ftHhZ<TV-)U3<~wr8=!`sR{e+KXo|
Kg8dEN-R88PHE8u`J4&HNz<S{5RdlxMx0$Z6a{xyV#py$xMT!Lfw{@X2X4&nJszqpHVrZ~`VEU8_e4
<8(_eU%4Dj6l?tQ9FuTATF{%xx<3(s|v{L;wz>;=}?qELv3Rzl8L3$5!+s7IHgb+;eRrbb}@o^d$$?
Lx8JR4*UDH`y9mS!fyTH=^Ud1BPGE9d`>Ef6kDu{(oxBpzwK~qR(wQmGPF?Kg@iOg*<wi*t^a=ts}=
g#aS??0P>R+FwYr9Y2l96Eh)J0X%fa=@xuGleMQ7;L!^(IryAoQUZ6fU%cJAShP8*huXt>0t!w)Jyl
dzHJv2q(mKxe7cx284<_vB#_j<-5k2zS+c`4ZsqAU~g{K>Eu&V~95KeWcJ!G&GZu+A#s*sd0_)@qb4
?;39{w#IjUxT`eMWX;(Aw_PExHW^(b&gB;lpqU*1f;D1KBIeEHRtwKr%-HYcoU(*Dk6sJGJ}bRe0CR
N})J|z=-L?iPH=+=ADjf?}IEa^n@+H6B3$*R0gW3%5=N0ci)fgLSDLd-dlTttUn$$1fb&74<Twc}Jz
a{3`%p6!4>pJdj<{3XAuia^8FDZk(Ef412Ay9wSfYyJM<7`zpraq>{xldP!LzeY2DnqP~zcXI_Nri9
Z*!!!hPgNP3CqCx(%c)Pp2e@wuQtI2rYpay!{?sZK_RmX<OEvrWQRbv_J%no$q&)#Je?1O{f&v_Nut
V0X`FQzC1Ts$rh_}9Kl+tPgjA5;not`HH+wadbb}ew2{_@0_;Q=m($_BW1NL0RaFipA3^-#XgMBj5*
bKU&Ry_`wwsaw{iLHel%#wnv=IOv4B++bvVrNR0QX~=ETi`wOD<*Y0RW6vk6EPj)H>)L$NQ}nx6ja#
uIzA9}^$pFtw?mj1?HWJjN68Y0etQ*L!b>!J!nG1W)q`MXoiUE-RXn}F~G#HMIMBNE3Ql6iM=G+kE&
vO#SV`HV%xV6^b&}8sEH29`VL0Z?)PyF{k^6Zewne)c<!};C%c2@eBt%tJKj5GS~kuTBr?VJy8u*No
4K^#*-K9CJ##X4B7%ti5=CUm6_LwRx}PJXaJ{D>uzd+1Pe+arV3pMFqR*CRqUYnGRM{J@X%S6hyz4=
|5u6s!%RZJt49&$6<I^|J1Zsb3Nq7hm?$X_XM>G>%MqXtykdC9MjP&H?Cts0v|qZn)gKUcCG9ayd|*
s~u)+(mCi1Iew~m4}T92d&iLZ4$c!+51<`_lzS#y%;}#*zA@5g6YJ_G&!%bUo4>#EhIl6x@^SVO>T=
7^tI^Xr3l}c7;NRP{IG;ILH2mN%xrR^By6s6e_?;YjSnNvhIGGl*sd3ThGae^%2e?NrQ|?pAX(EPxG
u~GAG6QR(m3}uePdj*y)zdix7ec;O0`2TbST+quyrBu*<6ZFTky^N<4ik?IZIsT8_tL&K*|XDWBibM
MQ@i)WmTBwXiyrf5z+~S6p2dz)zVE;pNU(3pLCT$ns_!}QZDQaSIX+W@*i;GW^AKpiR>APiQpDGjTS
nC2h3A;DOo(lpyyeW#=Uc~qE%h3{sq{~(A9QWrh?zIc5y3-;JQ~zbJE#;sU!v$W+r0z1&C1-HD!I*m
K8D!aM!dbx{{2NYq@Qb`&1{6><>iPx<Bhqg8F*n+35J@2MUX09(u}D#2KlTr`M8X4fBGH!F^i{r@0d
I#Fd{!@=>S;EQ@(4lTKT?%Pv5f|Qxvy()*${H#+bhs0`d3xkUy9JbM_2a_D7+kJ09I9jR-py3wJp~z
#1UgnF6&=k+Hq5LF;nt!ZOP=@6~>KUw++zF1OGD?sD&9jd>R28HxTHiGf~fL=|(RVQ$<QpUH&~;ck#
)7s7ad3oMp-D0T|Q*>|Sk#)p&O4xJc`9N8UZW(~^Q+>w9STSS!wNHGZ>R>Skbog)Xh%MDk0$*{irHQ
V?0jI?iI93shQ_px^u5$C@&u$Smadv!26Wx?QYkGj!QF!wz_{Ci~uoVpr?|0XJ@6+YGt`UFcxPSN4|
Igxu8R80K&KOZ@43_;-l&n)IDv%hUNAns&`zVAC2s1f~nmiwq(GI+M94G>pZV;`)cKA#NBm!lDXJOL
LLHDSM75L`6bVn|ej9P&V*dDH1)-RCnr{GT<?xn{pK{mX~!n^LdrsQ)itU$xz*Qlkld-}5me>%5bAx
J3MyF*a{-UTPQtG0F+@<Kv*Uro!?=Iy%mTvHaul;PVkUnLU;jYA2m|y3G8-PaeJAt6UC05Yf2v%jo8
p--__7b$u~?0KXHJJ{GL-8h>Xb=Gw^dHyMvC)>jPA=jjIFoeTMu6|C>+u<Y^2;VTQE`6vdPDn0SxG*
>bD)oSU|jbYjszjZKq$|K_4tcLCG2A};y+7a#lzx27k67x9ad%5f#a%o>5vwcUjnETtgzn*c}HxJ?m
_R#87Xk%Pq*gXv$e+z`iPcyKkR)h52OT>XiD<t1&jrB3VC7qexgX>;?&!gLOWzoG)J)AUae%HzY?vX
XhcP(spJ<GXGd|MfdHu~H{o<BsKtt0Nv4T6Xzw>&u##_J(4w6DTVgBC$6*Wj7sc9^AFB7Tqel+{~3t
XnUXs`Fgab1Lr}Qk_{AYJcn01XuU)DgA86D>#o+u*SGc<P$6R)%lzSS=TA_`(NzqPm)`#BOo1dhjn2
R423o9->wKs84cfZdpKPV5*yGYOV69E-`&YD%+ZGAteRMw74Wo6MtgbMXUQi00MFj<-u2k@8gnh#`W
SPqqo!@;T+qn4WH4U8uY!0l0P@A9u<kR$vNRLLr#%pqn1R5Um2kPgQ0!PVPdfd1uKC8U8Ev0`6WiW1
)_3Rm(A>ZkI~+1KA8Pv5cbzhSuT`E&664auzFwlHUTCF;P2qdW*<*64Q;*GI|Bit5mtn9RnuogXD0n
yqz<J9OIL(<P?md$$oqJ`x_WL^y>d)TG_5bm=dQI0`MLT|Ph+g<{F9zWAaOHWZt;R-ioAI}@=5*AD9
X!)*o-K}bFp)Fxfx*OD0IW^UFx)BOM3oMY%^JA<+Z98Oc#9_&CP=v-)mbYeV=aSpahH4|hvfOaUFze
NJ@FUc)VclgUHliE`zhaNqE@j|tE-8x4)(U|e9x=&ecm#N9&*bBI~X4(r+&H&H{Yy4(Cs4F?`XiVud
2lpM}6gs<!j7e&vP*Z&I`$TsAt55%M+rvl|Jm(a^h2;{{bqHXt@'''


@functools.lru_cache(maxsize=1)
def _vgrid_np():
    return decode_numpy_array(_VGRID)


def _check_dims(ndims):
    if ndims > MAX_DIMS:
        raise ValueError(f'the embedded Sobol grid holds MAX_DIMS = '
                         f'{MAX_DIMS} dimensions (max_depth <= '
                         f'{(MAX_DIMS - 2) // 6}), {ndims} requested')


def sobol_vgrid(ndims, device='cpu'):
    '''Direction-number grid [ndims, SOBOL_BITS] int32 (ndims <= MAX_DIMS).
    Unlike the functions that make scenes and films it defaults to the
    host: the grid is a host table, and a device copy is asked for by
    name.'''
    _check_dims(ndims)
    return torch.from_numpy(_vgrid_np()[:ndims].copy()).to(device)


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
    _check_dims(ndims)
    n = int(sample_index) + SKIP
    gray = n ^ (n >> 1)
    bits = ((gray >> np.arange(SOBOL_BITS)) & 1).astype(bool)
    v = _vgrid_np()[:ndims, bits].astype(np.int64)
    x = np.bitwise_xor.reduce(v, axis=1) if bits.any() \
        else np.zeros(ndims, np.int64)
    return x.astype(np.float32) * np.float32(1.0 / (1 << SOBOL_BITS))


def sobol_block(sample_index, ndims, device='cpu'):
    '''The [ndims] Sobol point for one sample index, with the SKIP
    burn-in.  Computed on the host (sobol_point) and
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


def hash_rotation(base, ndims):
    '''Cranley-Patterson rotation offsets [ndims, ...] in [0, 1] of per-ray
    hashes `base` (u32 values, or their int32 bit patterns):
    u32_to_unit(wanghash(base + d * 0x9e3779b9)) for d < ndims,
    dimension-major.'''
    base = torch.as_tensor(base).to(torch.int64) & 0xFFFFFFFF
    dims = torch.arange(ndims, dtype=torch.int64, device=base.device)
    dims = dims.reshape((ndims,) + (1,) * base.dim())
    h = wanghash((base[None] + dims * 0x9e3779b9) & 0xFFFFFFFF)
    return u32_to_unit(h)


def pixel_rotation(pix_i, pix_j, ndims):
    '''Per-pixel Cranley-Patterson rotation offsets [ndims, ...] in [0, 1],
    dimension-major like the reference.  Constant across sample indices.'''
    return hash_rotation(wanghash2(pix_i, pix_j), ndims)


def sample_dims(sample_index, pix_i, pix_j, ndims, rot=None):
    '''Per-pixel uniforms for one sample: rotated Sobol, [ndims, ...].
    rot: optional precomputed pixel_rotation(pix_i, pix_j, ndims) — pass
    it from per-sample loops, it costs ~10 integer ops per (dim, pixel).'''
    pt = sobol_block(sample_index, ndims, device=pix_i.device)
    pt = pt.reshape((ndims,) + (1,) * pix_i.dim())
    if rot is None:
        rot = pixel_rotation(pix_i, pix_j, ndims)
    return torch.remainder(pt + rot, 1.0)
