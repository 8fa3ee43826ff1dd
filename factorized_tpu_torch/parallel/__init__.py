"""Training several models at once on one card (port of
``factorized_tpu/parallel``): ``multiseed`` trains K seeds of one
configuration as K lanes of one program."""
