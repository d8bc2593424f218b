"""Core constants for bath_tpu_torch.

These mirror the Plan7 constants of the reference implementation
(see src/hmmer.h) but are re-declared here as plain
Python ints/floats for the framework.
"""

import math

# --- search modes (ref: hmmer.h p7_LOCAL etc.) ---
P7_NO_MODE = 0
P7_LOCAL = 1      # multihit local
P7_GLOCAL = 2     # multihit glocal
P7_UNILOCAL = 3   # unihit local
P7_UNIGLOCAL = 4  # unihit glocal


def is_local(mode: int) -> bool:
    return mode in (P7_LOCAL, P7_UNILOCAL)


def is_multihit(mode: int) -> bool:
    return mode in (P7_LOCAL, P7_GLOCAL)


# --- core HMM transition indices (ref: hmmer.h p7H_MM..p7H_DD) ---
H_MM, H_MI, H_MD, H_IM, H_II, H_DM, H_DD = range(7)

# --- profile transition indices (ref: hmmer.h p7P_*; 8 per node) ---
P_MM, P_IM, P_DM, P_BM, P_MD, P_DD, P_MI, P_II = range(8)
NTRANS = 8

# --- special state indices in xsc[4][2] (ref: hmmer.h p7P_E..p7P_J) ---
X_E, X_N, X_J, X_C = range(4)

LOOP, MOVE = 0, 1   # ref: hmmer.h enum p7p_xtransitions_e

# --- E-value parameter slots (ref: hmmer.h p7_MMU..p7_FTAUFS5) ---
EV_MMU, EV_MLAMBDA, EV_VMU, EV_VLAMBDA, EV_FTAU, EV_FLAMBDA, \
    EV_FTAUFS3, EV_FTAUFS5 = range(8)
NEVPARAM = 8
EVPARAM_UNSET = -99999.0

# --- Pfam cutoff slots (ref: hmmer.h p7_GA1..p7_TC2) ---
CUT_GA1, CUT_GA2, CUT_TC1, CUT_TC2, CUT_NC1, CUT_NC2 = range(6)
NCUTOFFS = 6
CUTOFF_UNSET = -99999.0

# --- frameshift codon-index system (ref: hmmer.h:270-316) ---
MAXNUC = 4
MAXCODONS5 = 1367    # 4+16+64+256+1024 + 3 degenerate slots
MAXCODONS3 = 338     # 16+64+256 + 2 degenerate slots
MAXCODONS1 = 65      # 64 + 1 degenerate slot
DEGEN5_C = 1364
DEGEN5_QC1 = 1365
DEGEN5_QC2 = 1366
DEGEN3_C = 336
DEGEN3_QC1 = 337
DEGEN1_C = 64

# offsets for codon index macros (ref: hmmer.h:292-303)
NUC1_FS5, NUC2_FS5, NUC3_FS5, NUC4_FS5 = 341, 85, 21, 5
NUC1_FS3, NUC2_FS3, NUC3_FS3 = 84, 21, 5
NUC1_FS1, NUC2_FS1 = 16, 4

# codon-length enum slots (ref: hmmer.h p7P_C1..C5)
C1, C2, C3, C4, C5 = range(5)


def codon1_fs5(x):         return x * NUC1_FS5
def codon2_fs5(w, x):      return x * NUC1_FS5 + w * NUC2_FS5 + C2
def codon3_fs5(v, w, x):   return x * NUC1_FS5 + w * NUC2_FS5 + v * NUC3_FS5 + C3
def codon4_fs5(u, v, w, x):
    return x * NUC1_FS5 + w * NUC2_FS5 + v * NUC3_FS5 + u * NUC4_FS5 + C4
def codon5_fs5(t, u, v, w, x):
    return x * NUC1_FS5 + w * NUC2_FS5 + v * NUC3_FS5 + u * NUC4_FS5 + t + C5


def codon2_fs3(w, x):      return x * NUC1_FS3 + w * NUC2_FS3
def codon3_fs3(v, w, x):   return x * NUC1_FS3 + w * NUC2_FS3 + v * NUC3_FS3 + C2
def codon4_fs3(u, v, w, x):
    return x * NUC1_FS3 + w * NUC2_FS3 + v * NUC3_FS3 + u + C3


def codon3_fs1(v, w, x):   return x * NUC1_FS1 + w * NUC2_FS1 + v


# indel placement codes (ref: hmmer.h enum p7p_rsc_indels)
I___X, I_X__, I_XX_, I_X_X, I__XX, I_XXX, I_XXx, I_XxX, I_xXX, I_xxx, \
    I_XXxX, I_XxXX, I_xXXX, I_XXxxX, I_XxxXX, I_xxXXX = range(16)

FSPROB_DEFAULT = 0.01   # ref: hmmer.h p7P_FSPROB

# --- pipeline constants (ref: p7_pipeline.c:200-203, bathsearch.c:31) ---
F1_DEFAULT = 0.02
F2_DEFAULT = 1e-3
F3_DEFAULT = 1e-5
F4_DEFAULT = 5e-4
BLOCK_LENGTH_DEFAULT = 1024 * 256    # 1/4 Mb DNA window read size

# --- misc math ---
CONST_LOG2 = math.log(2.0)
INF = float("inf")
NEG_INF = float("-inf")

# trace state codes (ref: hmmer.h p7T_*)
T_M, T_D, T_I, T_S, T_N, T_B, T_E, T_C, T_T, T_J, T_X = range(1, 12)

# strand / complementarity
NOCOMPLEMENT = 0
COMPLEMENT = 1

STRAND_BOTH = 0
STRAND_TOPONLY = 1
STRAND_BOTTOMONLY = 2

DEFAULT_WINDOW_BETA = 1e-7   # ref: p7_config p7_DEFAULT_WINDOW_BETA
