"""Sphinx configuration of the port's documentation (mirrors the JAX
package's docs/source/conf.py and reference Documentation/source/conf.py).

The dependency-free pipeline is ``python -m ntpoly_tpu_torch.docs.gen_api``
(markdown from live docstrings, committed in ``ntpoly_tpu_torch/docs/api``);
this scaffold serves users who have sphinx installed and want HTML with
autodoc and search:

    sphinx-build ntpoly_tpu_torch/docs/source OUTDIR
"""
project = "ntpoly_tpu_torch"
author = "ntpoly_tpu developers"
extensions = ["sphinx.ext.autodoc", "sphinx.ext.napoleon",
              "sphinx.ext.viewcode"]
autodoc_member_order = "bysource"
master_doc = "index"
exclude_patterns = ["_build"]
html_theme = "alabaster"
