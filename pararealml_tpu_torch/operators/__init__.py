from pararealml_tpu_torch.operators.symbol_mapper import SymbolMapper

__all__ = ["SymbolMapper"]
