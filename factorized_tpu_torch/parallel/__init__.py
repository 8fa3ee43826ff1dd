"""Training several models at once, and one model over several ranks
(port of ``factorized_tpu/parallel``): ``multiseed`` trains K seeds of
one configuration as K lanes of one program, ``multiconfig`` the
searches' trials as lanes, ``sharding`` lays ranks on a mesh (data and
tensor parallelism, lanes over ranks) and ``multiprocess`` runs a world
of ranks for real."""
