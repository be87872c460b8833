"""Cells of the benchmark cut to a size the CPU runs in seconds: the
real cells' files with the widths, depth, vocabulary and traffic made
tiny, and their real limits. The weights' std grows as the width
shrinks (0.02 x sqrt(4096 / 64)), so that activations and logits have
the spread they have at the cells' width of 4,096."""
from portbench import harness

TINY_MODEL = {'hidden_size': 64, 'num_hidden_layers': 2,
              'num_attention_heads': 4, 'num_key_value_heads': 2,
              'vocab_size': 256, 'initializer_range': 0.16}


def tiny_serve_cell() -> harness.Cell:
    harness.prepare_environment()
    cell = harness.load_cell('mistral7b.chat')
    cell.config.update(TINY_MODEL, intermediate_size=128)
    cell.config['deployment'].update(max_len=256, num_slots=4, block_k=16)
    cell.traffic.update(
        prompt={'median': 24, 'sigma': 0.9, 'min': 4, 'max': 128},
        output={'median': 8, 'sigma': 0.7, 'min': 2, 'max': 32},
        warm_seconds=0.5)
    cell.spec.update(rate_per_s=4.0, check_tokens=40)
    return cell


def narrow_serve_cell() -> harness.Cell:
    """The serving cell at its own depth and 1/32 of its width: rounding
    adds up over the 32 layers as it does at the cell's size, so the
    controls read there as they do on the card (bf16 0.13-0.36, int8
    weights 1.37-1.59 on seeds 3, 2**31 + 5 and 77, on the CPU)."""
    cell = tiny_serve_cell()
    depth = harness.load_cell('mistral7b.chat').config['num_hidden_layers']
    cell.config.update(hidden_size=128, intermediate_size=448,
                       num_attention_heads=4, num_key_value_heads=1,
                       vocab_size=512, num_hidden_layers=depth,
                       initializer_range=0.02 * (4096 / 128) ** 0.5)
    cell.traffic['output'] = {'median': 48, 'sigma': 0.7, 'min': 8,
                              'max': 128}
    cell.spec['check_tokens'] = 300
    return cell


def tiny_train_cell() -> harness.Cell:
    harness.prepare_environment()
    cell = harness.load_cell('mixtral8x7b.train')
    cell.config.update(TINY_MODEL, intermediate_size=96,
                       num_local_experts=4)
    cell.config['deployment']['ce_chunks'] = 4
    cell.traffic.update(batch=2, seq_len=64)
    return cell
