"""Folding-scheme support, on the card: multivariate polynomials
(cross-term computation for Nova-style folding of high-degree gates), the
arrabbiata accumulation scheme, its IVC over the Pasta cycle and its CLI.

Counterpart of proof_systems_tpu/folding. Reference capability: mvpoly/
(MVPoly trait + monomial representation) and arrabbiata/ (folding over the
Pasta cycle).
"""

from .mvpoly import MVPoly, compute_combined_cross_terms  # noqa: F401
