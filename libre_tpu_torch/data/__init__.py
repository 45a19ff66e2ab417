"""Data sources: URI-dispatched volume readers (mem://, raw://, NRRD,
lod://, UVF), numpy copies of ``libre_tpu.data``."""

from libre_tpu_torch.data.datasource import DataSource, DataSourcePlugin, register_datasource

__all__ = ["DataSource", "DataSourcePlugin", "register_datasource"]
