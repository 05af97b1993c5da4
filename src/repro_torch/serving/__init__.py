"""repro_torch.serving — the deprecated import path of the LM serving
functions (:mod:`repro_torch.serving.serve`, a shim onto
:mod:`repro_torch.models.lm_serve`)."""
