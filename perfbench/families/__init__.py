"""One module a model family, `<family>.py`, found by the `family` key of a
configuration file (`spec.family`). Each defines:

    model_config(cfg)                  the program's ModelConfig from the file's sizes
    make_weights(cfg, seed, device)    {kind: stacked tensor}, from the seed
    program_params(w, cfg)             the program's parameter tree, views of w
    reference_logits(w, cfg, served, judged, quant=None)
                                       the plain reference's fp32 logits at each
                                       judged request's served positions
    KERNELS                            the program's CUDA sources the family runs

A module whose name starts with `_` is shared code, not a family.
"""
