"""Mixture Dirichlet priors and mean-posterior parameter estimation
(ref: p7_prior.c p7_prior_CreateAmino :39, p7_ParameterEstimation
:298; easel esl_mixdchlet_MPParameters semantics).

The numeric prior parameters are published data: the match-emission
mixture is Sjolander's 9-component Blocks9 prior [Sjolander96]; the
transition Dirichlets are Mitchison's early-Pfam estimates; insert
emissions are the Pfam 1.0 polar prior.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np


# one ufunc built once: per-element math.lgamma with none of
# np.vectorize's per-call type-resolution overhead (bit-identical —
# the same math.lgamma evaluates every element)
_LGAMMA_UF = np.frompyfunc(math.lgamma, 1, 1)


def _gammaln(x):
    x = np.asarray(x, dtype=np.float64)
    return _LGAMMA_UF(x).astype(np.float64)


@dataclass
class Dirichlet:
    """One mixture Dirichlet: q [ncomp], alpha [ncomp, K]."""
    q: np.ndarray
    alpha: np.ndarray

    def mp_parameters(self, c: np.ndarray) -> np.ndarray:
        """Mean posterior p[a] given counts c (esl_mixdchlet
        MPParameters): mixture responsibilities from the
        Dirichlet-multinomial marginal likelihood, then the
        responsibility-weighted posterior means."""
        c = np.asarray(c, dtype=np.float64)
        a = self.alpha                                  # [n, K]
        cache = self.__dict__.get("_lg_cache")
        if cache is None:
            # alpha-only terms are constant across calls
            asum = a.sum(axis=1)
            cache = (asum, _gammaln(asum), _gammaln(a))
            self.__dict__["_lg_cache"] = cache
        asum, lg_asum, lg_a = cache
        csum = c.sum()
        # log marginal likelihood of c under each component
        ll = (lg_asum - _gammaln(csum + asum)
              + (_gammaln(c[None, :] + a) - lg_a).sum(axis=1))
        ll += np.log(self.q)
        ll -= ll.max()
        resp = np.exp(ll)
        resp /= resp.sum()
        post = (c[None, :] + a) / (csum + asum)[:, None]   # [n, K]
        return (resp[:, None] * post).sum(axis=0)


@dataclass
class Prior:
    tm: Dirichlet     # match transitions (MM, MI, MD)
    ti: Dirichlet     # insert transitions (IM, II)
    td: Dirichlet     # delete transitions (DM, DD)
    em: Dirichlet     # match emissions [K]
    ei: Dirichlet     # insert emissions [K]


_AMINO_MATCH_Q = [0.178091, 0.056591, 0.0960191, 0.0781233, 0.0834977,
                  0.0904123, 0.114468, 0.0682132, 0.234585]

_AMINO_MATCH_ALPHA = [
    [0.270671, 0.039848, 0.017576, 0.016415, 0.014268, 0.131916,
     0.012391, 0.022599, 0.020358, 0.030727, 0.015315, 0.048298,
     0.053803, 0.020662, 0.023612, 0.216147, 0.147226, 0.065438,
     0.003758, 0.009621],
    [0.021465, 0.010300, 0.011741, 0.010883, 0.385651, 0.016416,
     0.076196, 0.035329, 0.013921, 0.093517, 0.022034, 0.028593,
     0.013086, 0.023011, 0.018866, 0.029156, 0.018153, 0.036100,
     0.071770, 0.419641],
    [0.561459, 0.045448, 0.438366, 0.764167, 0.087364, 0.259114,
     0.214940, 0.145928, 0.762204, 0.247320, 0.118662, 0.441564,
     0.174822, 0.530840, 0.465529, 0.583402, 0.445586, 0.227050,
     0.029510, 0.121090],
    [0.070143, 0.011140, 0.019479, 0.094657, 0.013162, 0.048038,
     0.077000, 0.032939, 0.576639, 0.072293, 0.028240, 0.080372,
     0.037661, 0.185037, 0.506783, 0.073732, 0.071587, 0.042532,
     0.011254, 0.028723],
    [0.041103, 0.014794, 0.005610, 0.010216, 0.153602, 0.007797,
     0.007175, 0.299635, 0.010849, 0.999446, 0.210189, 0.006127,
     0.013021, 0.019798, 0.014509, 0.012049, 0.035799, 0.180085,
     0.012744, 0.026466],
    [0.115607, 0.037381, 0.012414, 0.018179, 0.051778, 0.017255,
     0.004911, 0.796882, 0.017074, 0.285858, 0.075811, 0.014548,
     0.015092, 0.011382, 0.012696, 0.027535, 0.088333, 0.944340,
     0.004373, 0.016741],
    [0.093461, 0.004737, 0.387252, 0.347841, 0.010822, 0.105877,
     0.049776, 0.014963, 0.094276, 0.027761, 0.010040, 0.187869,
     0.050018, 0.110039, 0.038668, 0.119471, 0.065802, 0.025430,
     0.003215, 0.018742],
    [0.452171, 0.114613, 0.062460, 0.115702, 0.284246, 0.140204,
     0.100358, 0.550230, 0.143995, 0.700649, 0.276580, 0.118569,
     0.097470, 0.126673, 0.143634, 0.278983, 0.358482, 0.661750,
     0.061533, 0.199373],
    [0.005193, 0.004039, 0.006722, 0.006121, 0.003468, 0.016931,
     0.003647, 0.002184, 0.005019, 0.005990, 0.001473, 0.004158,
     0.009055, 0.003630, 0.006583, 0.003172, 0.003690, 0.002967,
     0.002772, 0.002686],
]

_AMINO_INSERT_ALPHA = [681., 120., 623., 651., 313., 902., 241., 371.,
                       687., 676., 143., 548., 647., 415., 551., 926.,
                       623., 505., 102., 269.]


def amino_prior() -> Prior:
    """Default protein prior (ref: p7_prior_CreateAmino :39)."""
    return Prior(
        tm=Dirichlet(np.array([1.0]),
                     np.array([[0.7939, 0.0278, 0.0135]])),
        ti=Dirichlet(np.array([1.0]), np.array([[0.1551, 0.1331]])),
        td=Dirichlet(np.array([1.0]), np.array([[0.9002, 0.5630]])),
        em=Dirichlet(np.array(_AMINO_MATCH_Q),
                     np.array(_AMINO_MATCH_ALPHA)),
        ei=Dirichlet(np.array([1.0]), np.array([_AMINO_INSERT_ALPHA])),
    )


def laplace_prior(K: int) -> Prior:
    """+1 Laplace prior (ref: p7_prior_CreateLaplace)."""
    one = lambda n: Dirichlet(np.array([1.0]), np.ones((1, n)))
    return Prior(tm=one(3), ti=one(2), td=one(2), em=one(K), ei=one(K))


def parameter_estimation(hmm, pri: Prior | None):
    """Counts -> mean posterior probabilities, in place
    (ref: p7_prior.c p7_ParameterEstimation :298).  <pri> None means
    plain frequency normalization."""
    M, K = hmm.M, hmm.abc.K
    from . import constants as C

    if pri is None:
        # normalize each distribution
        for k in range(M + 1):
            for sl in ((0, 3), (3, 5), (5, 7)):
                v = hmm.t[k, sl[0]:sl[1]]
                s = v.sum()
                if s > 0:
                    hmm.t[k, sl[0]:sl[1]] = v / s
            for arr in (hmm.mat, hmm.ins):
                s = arr[k].sum()
                if s > 0:
                    arr[k] /= s
    else:
        for k in range(M + 1):
            hmm.t[k, 0:3] = pri.tm.mp_parameters(hmm.t[k, 0:3])
        hmm.t[M, C.H_MD] = 0.0
        hmm.t[M, 0:3] /= hmm.t[M, 0:3].sum()
        for k in range(M + 1):
            hmm.t[k, 3:5] = pri.ti.mp_parameters(hmm.t[k, 3:5])
        for k in range(1, M):
            hmm.t[k, 5:7] = pri.td.mp_parameters(hmm.t[k, 5:7])
        for k in range(1, M + 1):
            hmm.mat[k, :K] = pri.em.mp_parameters(hmm.mat[k, :K])
        for k in range(M + 1):
            hmm.ins[k, :K] = pri.ei.mp_parameters(hmm.ins[k, :K])
    # conventions (ref: p7_ParameterEstimation :317-349)
    hmm.t[0, C.H_DM] = hmm.t[M, C.H_DM] = 1.0
    hmm.t[0, C.H_DD] = hmm.t[M, C.H_DD] = 0.0
    hmm.mat[0, :] = 0.0
    hmm.mat[0, 0] = 1.0
